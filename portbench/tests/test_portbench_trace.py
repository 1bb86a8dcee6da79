"""The trace reduction on a synthetic chrome trace: span attribution by
correlation id, busy unions, the common interval and the idle gaps."""
from __future__ import annotations

import pytest

from portbench import trace
from portbench.run import gaps_of


def ev(name, cat, ts, dur, tid=1, **args):
    e = dict(ph='X', name=name, cat=cat, ts=ts, dur=dur, tid=tid)
    if args:
        e['args'] = args
    return e


def synthetic():
    """Two marks noted, at monotonic 9.9 s and 10 s; only the second's
    launch recorded, at ts 1000 us. Two frames; the
    first holds a patchify span. Kernels: two of frame 1 overlapping each
    other, one of frame 2, one launched outside any frame."""
    events = [
        ev('cudaLaunchKernel', 'cuda_runtime', 1000, 1, correlation=9),
        ev('spin_kernel(long)', 'kernel', 1001, 1, tid=7, correlation=9),
        ev('cudaLaunchKernel', 'cuda_runtime', 1160, 5, correlation=1),
        ev('cudaLaunchKernel', 'cuda_runtime', 1300, 5, correlation=2),
        ev('cudaLaunchKernel', 'cuda_runtime', 1700, 5, correlation=3),
        ev('cudaMemsetAsync', 'cuda_runtime', 2000, 5, correlation=4),
        ev('k_a', 'kernel', 1200, 100, tid=7, correlation=1),
        ev('k_b', 'kernel', 1250, 100, tid=7, correlation=2),
        ev('k_c', 'kernel', 1800, 50, tid=7, correlation=3),
        ev('k_d', 'gpu_memset', 2100, 10, tid=7, correlation=4),
    ]
    spans = dict(frame=[(10.0001, 10.0005), (10.0006, 10.0009)],
                 patchify=[(10.00015, 10.00025)])
    return events, spans


def test_union_and_clip():
    assert trace.union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]
    assert trace.length([[0, 1], [2, 5]]) == 4
    assert trace.clip([[0, 4], [6, 8]], 1, 7) == [[1, 4], [6, 7]]


def test_span_facts_and_busy():
    t = trace.Trace(synthetic()[0], [9.9, 10.0], synthetic()[1])
    f = t.span_facts('frame')
    assert f['calls'] == 2 and f['ops'] == 3
    assert abs(f['device_s'] - 250e-6) < 1e-9
    # k_a and k_b overlap: their union is 150 us, plus k_c's 50
    assert abs(f['busy_s'] - 200e-6) < 1e-9
    p = t.span_facts('patchify')
    assert p['calls'] == 1 and p['ops'] == 1
    assert abs(p['device_s'] - 100e-6) < 1e-9
    k = t.span_facts('frame', kernel='k_c')
    assert k['ops'] == 1 and k['per_call'] == [0.0, 50e-6]
    # monotonic: ts 1000 us is 10 s
    busy = t.busy(10.0, 10.001)
    # the mark kernel (1 us), k_a with k_b, k_c; k_d lies past 10.001
    assert [[round(a, 9), round(b, 9)] for a, b in busy] == \
        [[10.000001, 10.000002], [10.0002, 10.00035], [10.0008, 10.00085]]
    assert abs(trace.length(busy) - 201e-6) < 1e-9
    assert t.frames_ending_in(10.0, 10.0006) == 1
    assert abs(t.by_name(10.0, 10.0003)['k_b'] - 50e-6) < 1e-9


def test_idle_gaps_across_clients_and_host_attribution():
    a = [[0.0, 1.0], [3.0, 4.0]]
    b = [[0.5, 2.0]]
    assert gaps_of([a, b], 0.0, 5.0) == [[2.0, 3.0], [4.0, 5.0]]
    t = trace.Trace(synthetic()[0], [9.9, 10.0], synthetic()[1])
    got = t.host_during([[10.00062, 10.00068]])
    assert list(got) == ['portbench.frame']
    got = t.host_during([[10.0091, 10.0093]])
    assert list(got) == ['_no_host_op_']


def test_the_clock_offset_survives_dropped_launches():
    # notes 60-80 ms apart (a host-paced frame); each launch follows its
    # note by 20 us on a trace clock 5 s ahead; launches 0, 1 and 7
    # unrecorded, so launches paired with notes in order from either end
    # would be a frame off
    import random
    rng = random.Random(3)
    marks, t = [], 100.0
    for _ in range(12):
        marks.append(t)
        t += rng.uniform(0.06, 0.08)
    launches = [(m + 5.0) * 1e6 + 20.0 for k, m in enumerate(marks)
                if k not in (0, 1, 7)]
    assert abs(trace.clock_offset(launches, marks) - (5e6 + 20.0)) < 1.0
    with pytest.raises(RuntimeError):
        trace.clock_offset(launches[:4], [m + rng.uniform(0.01, 0.05)
                                          for m in marks[5:]])
