"""dpvo_torch.tracing: the span recorder alone, and its spans in DeviceVO's
frame on the CPU, in the micro configuration of test_torch_runtime.py (64x96
frames, 8 patches, f32, artifacts/micro_vonet.npz, force_accept): 20 frames
through __call__, and the same frames through track_frames in chunks of 4.
The bootstrap is frame 7; keyframes are removed from frame 8 on."""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from torch.utils._python_dispatch import TorchDispatchMode

from dpvo_torch import tracing
from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.runtime import DeviceVO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')
H, W = 64, 96
INTR = np.array([60.0, 60.0, W / 2, H / 2], np.float32)
T = 20
BOOT = 7
# the spans that hold vo_frame's device work (vo.iter holds only its three
# children's)
STAGES = {'vo.patchify', 'vo.store', 'vo.probe', 'vo.pairs', 'vo.edges',
          'vo.corr', 'vo.update', 'vo.ba', 'vo.keyframe', 'vo.shift'}
PARENT = {'vo.step': 'vo.frame', 'vo.patchify': 'vo.step',
          'vo.store': 'vo.step', 'vo.probe': 'vo.step', 'vo.pairs': 'vo.step',
          'vo.edges': 'vo.step', 'vo.iter': 'vo.step', 'vo.corr': 'vo.iter',
          'vo.update': 'vo.iter', 'vo.ba': 'vo.iter',
          'vo.keyframe': 'vo.step', 'vo.shift': 'vo.keyframe'}


def _cfg():
    c = torch_cfg.clone()
    c.merge_from_file(os.path.join(REPO, 'config', 'default.yaml'))
    c.PATCHES_PER_FRAME = 8
    c.BUFFER_SIZE = 64
    c.MIXED_PRECISION = False
    c.REMOVAL_WINDOW = 8
    c.OPTIMIZATION_WINDOW = 6
    c.PATCH_LIFETIME = 5
    c.KEYFRAME_INDEX = 2
    return c


def _frames(n, seed=0, step=(3, 2)):
    """Smooth seeded texture seen through a crop moving `step` px/frame."""
    rng = np.random.RandomState(seed)
    sx, sy = step
    tex = gaussian_filter(rng.rand(H + sy * n, W + sx * n, 3), (2, 2, 0))
    tex = (tex - tex.min()) / np.ptp(tex) * 255
    return np.stack([tex[sy * t:sy * t + H, sx * t:sx * t + W]
                     for t in range(n)]).astype(np.uint8)


@pytest.fixture(autouse=True)
def tracer_off():
    """Each test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _run(trace, chunk=None, frames=T, force_accept=True):
    """(vo, records, (before, after) in monotonic s) of `frames` frames
    through __call__ (chunk None) or track_frames in chunks."""
    imgs = _frames(frames)
    vo = DeviceVO(_cfg(), NPZ, ht=H, wd=W, seed=0, device='cpu')
    vo.force_accept = force_accept
    torch.set_num_threads(1)
    if trace:
        tracing.enable()
    try:
        before = time.monotonic()
        if chunk is None:
            for t in range(frames):
                vo(t, imgs[t], INTR)
        else:
            for t in range(0, frames, chunk):
                vo.track_frames(list(range(t, t + chunk)), imgs[t:t + chunk],
                                INTR)
        after = time.monotonic()
    finally:
        tracing.disable()
    return vo, tracing.drain(), (before, after)


@pytest.fixture(scope='module')
def runs():
    """The traced runs through __call__ and track_frames, and an untraced
    one, made once for the module."""
    threads = torch.get_num_threads()
    tracing.disable()
    tracing.drain()
    try:
        return {'call': _run(True), 'chunk': _run(True, chunk=4),
                'off': _run(False)}
    finally:
        torch.set_num_threads(threads)


def test_recorder_nests_tags_and_drains():
    assert tracing.span('a') is tracing.span('b')    # the shared no-op
    tracing.frame(5)
    with tracing.span('off'):
        pass
    assert tracing.drain() == []
    tracing.enable()
    tracing.frame(3)
    with tracing.span('outer', k=1):
        with tracing.span('inner'):
            pass
        tracing.frame(4)
        with tracing.span('next'):
            pass
    tracing.disable()
    with tracing.span('after'):
        pass
    recs = tracing.drain()
    assert [r.name for r in recs] == ['outer', 'inner', 'next']
    assert [r.parent for r in recs] == [None, 0, 0]
    assert [r.frame for r in recs] == [3, 3, 4]
    assert recs[0].attrs == {'k': 1} and recs[1].attrs == {}
    assert {r.thread for r in recs} == {threading.get_ident()}
    outer, inner, nxt = recs
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= nxt.t0_ns \
        <= nxt.t1_ns <= outer.t1_ns
    assert tracing.drain() == []


def _spans_in_threads(n, drain_meanwhile):
    """n threads, each 200 outer spans holding an inner one, started
    together and switching every microsecond; drained while they run
    (drain_meanwhile) or once after. The batches drained."""
    barrier = threading.Barrier(n + 1)

    def work(i):
        tracing.frame(i)
        barrier.wait(timeout=10)
        for _ in range(200):
            with tracing.span('outer'):
                with tracing.span('inner'):
                    time.sleep(0)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    batches = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        for th in threads:
            th.start()
        barrier.wait(timeout=10)
        while drain_meanwhile and any(th.is_alive() for th in threads):
            batches.append(tracing.drain())
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
        tracing.disable()
    return batches + [tracing.drain()]


@pytest.mark.parametrize('drain_meanwhile', [False, True])
def test_spans_of_threads(drain_meanwhile):
    """Spans of 16 threads name parents on their own thread only, and
    none is lost, also when drained while the threads run (a parent
    drained in an earlier batch is None)."""
    batches = _spans_in_threads(16, drain_meanwhile)
    names = [r.name for b in batches for r in b]
    assert names.count('outer') == names.count('inner') == 16 * 200
    for b in batches:
        for r in b:
            if r.name == 'outer':
                assert r.parent is None
            elif r.parent is not None:
                p = b[r.parent]
                assert p.name == 'outer' and p.thread == r.thread
                assert p.frame == r.frame
                assert p.t0_ns <= r.t0_ns
            else:
                assert drain_meanwhile
    if not drain_meanwhile:
        assert all(r.t1_ns is not None and (
            r.parent is None or r.t1_ns <= batches[0][r.parent].t1_ns)
            for r in batches[0])


@pytest.mark.parametrize('mode', ['call', 'chunk'])
def test_frame_spans(runs, mode):
    _, recs, (before, after) = runs[mode]
    by_frame = {}
    for r in recs:
        assert r.t1_ns is not None
        assert before <= r.t0_ns / 1e9 <= r.t1_ns / 1e9 <= after
        by_frame.setdefault(r.frame, []).append(r)
        if r.parent is not None:
            p = recs[r.parent]
            assert p.frame == r.frame and p.thread == r.thread
            assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
        if r.name in PARENT:
            assert r.parent is not None and \
                recs[r.parent].name == PARENT[r.name]
        elif r.name in ('vo.draw', 'vo.pack', 'vo.upload'):
            # inside the frame's vo.frame, or before a chunk's steps
            want = 'vo.frame' if mode == 'call' else None
            assert (recs[r.parent].name if r.parent is not None
                    else None) == want
        else:
            assert r.name == 'vo.frame' and r.parent is None, r
    assert sorted(by_frame) == list(range(T))
    for f, rs in by_frame.items():
        names = [r.name for r in rs]
        assert names.count('vo.frame') == 1 and names.count('vo.step') == 1
        assert names.count('vo.draw') == names.count('vo.pack') == 1
        # a chunk's one upload is tagged with its first frame
        assert names.count('vo.upload') == int(mode == 'call' or f % 4 == 0)
        iters = 12 if f == BOOT else int(f > BOOT)
        assert names.count('vo.iter') == iters
        for s in ('vo.corr', 'vo.update', 'vo.ba'):
            assert names.count(s) == iters
        # _update_ba sets up its edges on every accepted frame, pre-init
        # ones too (with no iteration)
        assert names.count('vo.edges') == 1
        assert names.count('vo.keyframe') == names.count('vo.shift') \
            == int(f > BOOT)
        assert names.count('vo.probe') == 0          # force_accept
        for s in ('vo.patchify', 'vo.store', 'vo.pairs'):
            assert names.count(s) == 1
    up = [r for r in recs if r.name == 'vo.upload']
    assert sum(r.attrs['bytes'] for r in up) == runs[mode][0].h2d_bytes


def test_tracer_off_records_nothing(runs):
    assert runs['off'][1] == []


@pytest.mark.parametrize('mode', ['call', 'chunk'])
def test_state_is_bit_identical_with_the_tracer_on(runs, mode):
    on, off = runs[mode][0].st, runs['off'][0].st
    assert on.host_n == off.host_n
    a, b = on.tensors(), off.tensors()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_probe_span_before_initialization():
    """Without force_accept each pre-init frame after the first runs the
    motion probe inside vo.step."""
    _, recs, _ = _run(True, frames=4, force_accept=False)
    probes = [r for r in recs if r.name == 'vo.probe']
    assert [r.frame for r in probes] == [1, 2, 3]
    assert all(recs[r.parent].name == 'vo.step' for r in probes)


class _Ops(TorchDispatchMode):
    """The monotonic time and name of every aten op dispatched."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((time.monotonic_ns(), func))
        return func(*args, **(kwargs or {}))


def test_every_op_of_the_step_lies_in_a_stage():
    """Every aten op but views that vo.step dispatches, over the
    bootstrap and steady frames, lies in a stage span: none in vo.step's
    or vo.iter's own time (with an rgb row, unpack_frame only views)."""
    ops = _Ops()
    with ops:
        _, recs, _ = _run(True, frames=11)
    steps = [r for r in recs if r.name == 'vo.step']
    inner = sorted((r for r in recs if r.name in STAGES or
                    r.name == 'vo.iter'), key=lambda r: r.t0_ns)
    seen = set()
    for t, func in ops.ops:
        if not any(s.t0_ns <= t <= s.t1_ns for s in steps):
            continue
        holders = [r for r in inner if r.t0_ns <= t <= r.t1_ns]
        name = holders[-1].name if holders else 'vo.step'
        if func.is_view:
            continue
        assert name in STAGES, (func, name)
        seen.add(name)
    assert seen == STAGES - {'vo.probe'}
