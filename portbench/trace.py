"""Reduction of one client's torch.profiler trace (CUDA activity only) to
the facts the per-layer metrics read.

Device operations are the trace's kernel, memcpy and memset events; each
is tied to the host launch that made it (a cuda_runtime event) by the
profiler's correlation id, and a launch to every span that holds it on the
client's thread. The spans are the harness's own, timed on the host's
CLOCK_MONOTONIC: tracing the host's operators too would double the host's
work per frame and starve the card it measures. Marks put the trace on
that clock: before each traced frame the client notes the monotonic time
and launches a sleep kernel (MARK); the offset of the launches' trace
times from those notes maps one clock onto the other, so the clients'
traces also share the interval they are clipped to. The profiler can
leave some launches unrecorded, at its start or anywhere else, so the
offset is not read from launches and notes paired in order: it is the
one that most recorded launches follow (`clock_offset`).
"""
from __future__ import annotations

import bisect
import json
import statistics
from collections import defaultdict

DEVICE = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH = ('cuda_runtime', 'cuda_driver')
MARK = 'spin_kernel'       # torch.cuda._sleep's kernel
PREFIX = 'portbench.'


def load(path):
    with open(path) as f:
        return [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']


def union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def length(intervals):
    return sum(b - a for a, b in intervals)


def clock_offset(launches, marks, width=300.0):
    """The trace's clock less the monotonic one (us): of the differences
    between every recorded mark launch (trace us) and every note (s), the
    median of the densest run `width` us wide, which most launches join
    (a launch follows its note by tens of microseconds; a launch against
    a note of another frame differs by a frame's time, which varies from
    frame to frame). Ties go to the run nearest the launches and notes
    paired from the last one back. Raises where under half the launches
    join it."""
    d = sorted(ts - m * 1e6 for ts in launches for m in marks)
    tail = statistics.median(ts - m * 1e6 for ts, m in zip(
        reversed(sorted(launches)), reversed(marks)))
    best, j = None, 0
    for i in range(len(d)):
        while d[i] - d[j] > width:
            j += 1
        mid = statistics.median(d[j:i + 1])
        key = (i - j + 1, -abs(mid - tail))
        if best is None or key > best[0]:
            best = (key, mid)
    (count, _), mid = best
    if 2 * count < len(launches):
        raise RuntimeError(f'{count} of {len(launches)} mark launches agree '
                           f'on the clock offset')
    return mid


def clip(intervals, lo, hi):
    return [[max(a, lo), min(b, hi)] for a, b in intervals
            if b > lo and a < hi]


class Trace:
    """One client's trace: `marks` the monotonic times (s) the client
    noted just before launching each mark; `spans` {name: [(start, end)]}
    its spans in monotonic seconds."""

    def __init__(self, events, marks, spans):
        self.dev = [e for e in events if e.get('cat') in DEVICE]
        runtime = [e for e in events if e.get('cat') in LAUNCH
                   and 'args' in e]
        corr = {e['args'].get('correlation') for e in self.dev
                if MARK in e['name']}
        launch = sorted((e for e in runtime
                         if e['args'].get('correlation') in corr),
                        key=lambda e: e['ts'])
        if not launch or len(launch) > len(marks):
            raise RuntimeError(f'trace has {len(launch)} launches of the '
                               f'mark kernel for {len(marks)} marks')
        self.t0 = clock_offset([e['ts'] for e in launch], marks)
        tid = launch[-1]['tid']
        self.spans = {k: sorted((self.us(a), self.us(b)) for a, b in v)
                      for k, v in spans.items()}
        self.launch = sorted((e['ts'], e['args'].get('correlation'))
                             for e in runtime if e.get('tid') == tid)
        self.host = sorted([(a, b, PREFIX + k) for k, v in self.spans.items()
                            for a, b in v] +
                           [(e['ts'], e['ts'] + e.get('dur', 0), e['name'])
                            for e in runtime if e.get('tid') == tid],
                           key=lambda x: (x[0], -x[1]))
        self.by_corr = defaultdict(list)
        for e in self.dev:
            c = e.get('args', {}).get('correlation')
            if c is not None:
                self.by_corr[c].append(e)

    def mono(self, ts):
        return (ts - self.t0) / 1e6

    def us(self, mono):
        return mono * 1e6 + self.t0

    def inside(self, name, outer='frame'):
        """The `name` ranges that lie inside an `outer` range."""
        outs = self.spans.get(outer, [])
        starts = [a for a, _ in outs]
        keep = []
        for a, b in self.spans.get(name, []):
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= outs[i][1]:
                keep.append((a, b))
        return keep

    def device_of(self, ranges):
        """[device events] launched inside each of `ranges`, per range."""
        ts = [t for t, _ in self.launch]
        out = []
        for a, b in ranges:
            got = []
            for _, c in self.launch[bisect.bisect_left(ts, a):
                                    bisect.bisect_right(ts, b)]:
                got.extend(self.by_corr.get(c, ()))
            out.append(got)
        return out

    def span_facts(self, name, kernel=None):
        """calls, device seconds, device ops and busy seconds (union) of
        the `name` ranges inside whole frames; `kernel`: count only device
        events whose name holds it. Also the per-call device seconds."""
        ranges = self.inside(name) if name != 'frame' else \
            self.spans.get('frame', [])
        per = self.device_of(ranges)
        if kernel:
            per = [[e for e in evs if kernel in e['name']] for evs in per]
        dur = [sum(e.get('dur', 0) for e in evs) / 1e6 for evs in per]
        busy = length(union([(e['ts'], e['ts'] + e.get('dur', 0))
                             for evs in per for e in evs])) / 1e6
        return dict(calls=len(ranges), device_s=sum(dur),
                    ops=sum(len(evs) for evs in per), busy_s=busy,
                    per_call=dur)

    def busy(self, lo, hi):
        """Merged device-busy intervals (monotonic seconds) in [lo, hi]."""
        iv = union([(self.mono(e['ts']), self.mono(e['ts'] + e.get('dur', 0)))
                    for e in self.dev])
        return clip(iv, lo, hi)

    def frames_ending_in(self, lo, hi):
        return sum(1 for _, b in self.spans.get('frame', [])
                   if lo <= self.mono(b) <= hi)

    def by_name(self, lo, hi):
        out = defaultdict(float)
        for e in self.dev:
            a, b = self.mono(e['ts']), self.mono(e['ts'] + e.get('dur', 0))
            if b > lo and a < hi:
                out[e['name']] += min(b, hi) - max(a, lo)
        return dict(out)

    def host_during(self, gaps):
        """{host range: seconds} of the innermost host range on the
        client's thread (a span, or a CUDA runtime call) at the middle of
        each gap, weighted by the gap's length (`_no_host_op_` where none
        runs)."""
        starts = [h[0] for h in self.host]
        out = defaultdict(float)
        for a, b in gaps:
            mid = self.us(0.5 * (a + b))
            name = '_no_host_op_'
            i = bisect.bisect_right(starts, mid)
            best = None
            for h in reversed(self.host[max(0, i - 400):i]):
                if h[1] >= mid and (best is None or h[0] >= best[0]):
                    best = h
            if best is not None:
                name = best[2]
            out[name] += b - a
        return dict(out)
