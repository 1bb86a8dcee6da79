"""One VO client of a portbench run, forked by portbench.run and driven
over a pair of pipes (one JSON object per line each way; everything else
the client prints goes to standard error).

Messages in: the run's settings, at once; `warm` once the parent has
built the CUDA libraries; `go` (release time, deadline, traced interval);
then `trace`, `gaps`, `solo`, `check`, `exit` in that order as the run
needs them. On the settings the client builds VONet from the seed's
weights on the card, a DeviceVO with force_accept (random weights never
pass the motion probe) and renders its frames; on `warm` it runs the
bootstrap and a warm-up; on `go` it calls DeviceVO.__call__ frame after
frame until the deadline.
"""
from __future__ import annotations

import functools
import gc
import importlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np


class Spans:
    """The spans of spans/*.json, wrapped around their targets while a
    traced run needs them: while a span's name is in `on`, each call's
    start and end on the host's monotonic clock go to log[name], and a
    span with a `bound` keeps its bound's capture of each call."""

    def __init__(self, specs):
        self.on = frozenset()
        self.log = defaultdict(list)
        self.records = defaultdict(list)
        self.specs = specs
        for name, spec in specs.items():
            owner, attr, fn = self._resolve(name, spec['target'])
            bound = importlib.import_module(
                f'portbench.bounds.{spec["bound"]}') if spec.get('bound') \
                else None
            setattr(owner, attr, self._wrap(name, fn, bound))

    def clear(self):
        for v in list(self.log.values()) + list(self.records.values()):
            v.clear()

    @staticmethod
    def _resolve(name, target):
        mod, _, path = target.partition(':')
        try:
            owner = importlib.import_module(mod)
            parts = path.split('.')
            for p in parts[:-1]:
                owner = getattr(owner, p)
            return owner, parts[-1], getattr(owner, parts[-1])
        except (ImportError, AttributeError) as e:
            raise RuntimeError(f'span {name!r}: its target {target!r} no '
                               f'longer exists ({e})') from e

    def _wrap(self, name, fn, bound):
        log, records = self.log[name], self.records[name]

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if name not in self.on:
                return fn(*args, **kwargs)
            if bound is not None:
                records.append(bound.capture(args, kwargs))
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            log.append((t0, time.monotonic()))
            return out
        return wrapped


def host_pace(dev, n=2000):
    """The host's pace: ms of a fixed pure-Python loop, us per launch of n
    one-element kernels queued back to back on dev (median of 3 each)."""
    import torch
    py, launch = [], []
    x = torch.zeros(1, device=dev)
    for _ in range(3):
        t0 = time.perf_counter()
        acc = 0
        for i in range(200_000):
            acc += i * i
        py.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            x.add_(1.0)
        torch.cuda.synchronize(dev)
        launch.append(1e6 * (time.perf_counter() - t0) / n)
    return float(np.median(py)), float(np.median(launch))


def program_net(config, seed, dev):
    """The program's VONet with the seeded weights, in the served
    precision, built on the meta device and given the weights' tensors."""
    import torch
    from dpvo_torch.models.vonet import VONet
    from .weights import make
    dtype = torch.bfloat16 if config['dpvo']['MIXED_PRECISION'] else \
        torch.float32
    net = VONet(device='meta')
    net.load_state_dict(make(config['network'], seed, dev, dtype),
                        strict=True, assign=True)
    return net.eval().requires_grad_(False)


def bad_modules():
    """Top-level names of loaded modules that a run may not hold."""
    from .spec import FORBIDDEN
    return sorted({m.split('.')[0] for m in list(sys.modules)} & FORBIDDEN)


class Client:
    """One client: Client(settings) builds the network, the runtime and the
    frames; warm_up() runs the warm-up frames (the bootstrap among them),
    which load the CUDA libraries."""

    def __init__(self, msg):
        import torch
        from .traffic import Sequence, seeds
        from .check import BA_TARGET, SOLVE_TARGET, UPDATE_TARGET, Recorder
        torch.set_num_threads(1)
        self.dev = torch.device(msg.get('device', 'cuda:0'))
        cfg_j, tr = msg['config'], msg['traffic']
        seed, idx = msg['seed'], msg['index']
        self.cfg_j, self.tr = cfg_j, tr
        self.seeds = dict(weights=seeds(seed, 'weights'),
                          vo=seeds(seed, 'vo', idx),
                          texture=seeds(seed, 'texture', idx),
                          check=seeds(seed, 'check', idx))
        self.H, self.W = cfg_j['height'], cfg_j['width']
        if self.dev.type == 'cuda':
            torch.cuda.set_device(self.dev)
            torch.zeros(1, device=self.dev)      # the CUDA context
        tc = time.monotonic()
        self.pace = host_pace(self.dev) if (idx == 0 and self.dev.type ==
                                            'cuda') else None
        t0 = time.monotonic()
        from dpvo_torch.config import cfg as base
        from dpvo_torch.runtime import DeviceVO
        cfg = base.clone()
        for k, v in cfg_j['dpvo'].items():
            cfg[k] = v
        cfg.UPLOAD_FORMAT = tr['upload']
        os.environ['DPVO_CORR_IMPL'] = cfg_j['corr_impl']
        self.net = program_net(cfg_j, self.seeds['weights'], self.dev)
        self.vo = DeviceVO(cfg, self.net, self.H, self.W,
                           seed=self.seeds['vo'], device=self.dev)
        self.vo.force_accept = True
        t1 = time.monotonic()
        self.seq = Sequence(tr, self.H, self.W, self.seeds['texture'])
        self.intr = self.seq.intrinsics
        t2 = time.monotonic()
        cf = tr['check_frame']
        self.warm = tr['warmup_frames']
        self.rec = Recorder(self.vo, self.warm + cf['first'] +
                            self.seeds['check'] % cf['span'])
        for (mod, name), hook in ((BA_TARGET, self.rec.hook),
                                  (SOLVE_TARGET, self.rec.hook_solve),
                                  (UPDATE_TARGET, self.rec.hook_update)):
            mod = importlib.import_module(mod)
            owner, _, attr = name.rpartition('.')
            owner = getattr(mod, owner) if owner else mod
            setattr(owner, attr, hook(getattr(owner, attr)))
        self.spans = None
        if msg['trace']:
            from .spec import spans
            self.spans = Spans(spans())
        self.t = 0
        self.setup = dict(imports_s=msg.get('imports_s'),
                          context_s=tc - msg.get('t_msg', tc),
                          net_s=t1 - t0, frames_s=t2 - t1)

    def warm_up(self):
        """The warm-up frames; with tracing, the last one under a profiler
        session that is thrown away."""
        t0 = time.monotonic()
        for t in range(self.warm):
            if self.spans is not None and t == self.warm - 1:
                self.prof_warm = self._warm_profiler(t)
            else:
                self.track(t)
        self.sync()
        self.t = self.warm
        self.setup['warmup_s'] = time.monotonic() - t0

    def _warm_profiler(self, t):
        """One profiler session around warm-up frame t, thrown away: the
        profiler's first start loads and subscribes CUPTI, which takes
        seconds, and would otherwise fall in the window. Returns the
        seconds its start and stop took."""
        from torch.profiler import ProfilerActivity, profile
        t0 = time.monotonic()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t1 = time.monotonic()
        self.track(t)
        self.sync()
        t2 = time.monotonic()
        prof.stop()
        return t1 - t0, time.monotonic() - t2

    def sync(self):
        import torch
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def track(self, t):
        self.rec.before(t)
        self.vo(t, self.seq.frame(t), self.intr)
        self.rec.after(t)

    def _mark(self):
        """The clock mark (trace.MARK): the monotonic time, then one tiny
        kernel."""
        import torch
        self.marks.append(time.monotonic())
        if self.dev.type == 'cuda':
            torch.cuda._sleep(1)

    def window(self, go):
        """Frames from the release until the deadline; the profiler over
        the traced interval, started and stopped between frames, with the
        frame span on (the others stay off: the card is shared, so device
        times inside spans would include other clients' turns)."""
        from torch.profiler import ProfilerActivity, profile
        t0, deadline = go['t0'], go['deadline']
        tr = go.get('trace')
        self.prof = None
        traced = False
        enq = []
        while time.monotonic() < t0:
            time.sleep(min(0.001, max(0.0, t0 - time.monotonic())))
        t, k = self.t, 0
        while True:
            now = time.monotonic()
            if now >= deadline:
                break
            if tr and not traced and self.prof is None and now >= tr[0]:
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                self.prof_start_s = time.monotonic() - now
                self.marks = []
                self.spans.on = frozenset({'frame'})
            elif self.prof is not None and not traced and now >= tr[1]:
                self._stop()
                traced = True
            if self.prof is not None and not traced:
                self._mark()
            c0 = time.perf_counter()
            self.track(t)
            enq.append((now, time.perf_counter() - c0,
                        self.prof is not None and not traced))
            t += 1
            k += 1
        self.sync()
        t_end = time.monotonic()
        self.t = t
        if self.prof is not None and not traced:
            self._stop()
        peak = self._peak()
        # the driver's host time per frame before the profiler starts
        self.enq = [d for s, d, _ in enq if not tr or s < tr[0]]
        # the rate before the profiler starts: frames begun per second,
        # which the card's pace sets once the launch queues are full
        self.fps_pre = sum(1 for s, _, _ in enq if s < tr[0]) / \
            (tr[0] - t0) if tr else None
        out = dict(frames=k, t_end=t_end, memory_peak_bytes=peak,
                   first_frame=self.warm, step_frame=self.rec.step_frame,
                   bad_modules=bad_modules())
        if tr:
            out.update(traced=[self.marks[0], self.stop_at],
                       profiler_s=dict(warm=self.prof_warm,
                                       start=self.prof_start_s,
                                       stop=self.prof_stop_s))
        return out

    def _peak(self):
        import torch
        return torch.cuda.max_memory_allocated(self.dev) \
            if self.dev.type == 'cuda' else 0

    def _stop(self):
        self.sync()
        self.stop_at = time.monotonic()
        self.prof.stop()
        self.prof_stop_s = time.monotonic() - self.stop_at
        self.spans.on = frozenset()

    def _reduce(self):
        """The Trace of the last profiler session; clears the marks for
        the next."""
        from .trace import Trace, load
        fd, path = tempfile.mkstemp(suffix='.json')
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            out = Trace(load(path), self.marks, self.spans.log)
        finally:
            os.unlink(path)
        self.prof = None
        self.marks = []
        return out

    def trace(self, lo, hi):
        """Facts of this client's trace of the window over [lo, hi]
        (monotonic s): its device-busy intervals and the frames it
        finished there."""
        self.tr_ = tr = self._reduce()
        self.spans.clear()
        return dict(busy=tr.busy(lo, hi),
                    frames_in=tr.frames_ending_in(lo, hi),
                    enqueue_s=self.enq, fps_pre=self.fps_pre)

    def gaps(self, gaps):
        return dict(host=self.tr_.host_during(gaps))

    def solo(self, frames):
        """`frames` more frames with every span on, under the profiler,
        while the other clients wait (the window has closed): no other
        context shares the card, so the device time of the kernels each
        span launched is that layer's own. The facts of each span, the
        device time by kernel name, and the card's busy time."""
        from torch.profiler import ProfilerActivity, profile
        self.sync()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.marks = []
        self.spans.on = frozenset(self.spans.specs)
        t0 = time.monotonic()
        for t in range(self.t, self.t + frames):
            self._mark()
            self.track(t)
        self.sync()
        t1 = time.monotonic()
        self.t += frames
        self.prof.stop()
        self.spans.on = frozenset()
        tr = self._reduce()
        spans = {}
        for name, spec in self.spans.specs.items():
            f = tr.span_facts(name, spec.get('kernel'))
            if spec.get('bound'):
                bound = importlib.import_module(
                    f'portbench.bounds.{spec["bound"]}')
                recs = self.spans.records[name]
                pairs = [(bound.seconds(r), d) for r, d in zip(
                    recs, f['per_call']) if d > 0]
                f['bound_s'] = sum(b for (b, _), _ in pairs)
                f['bound_device_s'] = sum(d for _, d in pairs)
                f['bound_calls'] = len(pairs)
                f['live'] = [nv for (_, nv), _ in pairs]
            del f['per_call']
            spans[name] = f
        self.spans.clear()
        busy = tr.busy(t0, t1)
        return dict(spans=spans, frames=frames, seconds=t1 - t0,
                    busy_s=sum(b - a for a, b in busy),
                    by_name=sorted(tr.by_name(t0, t1).items(),
                                   key=lambda kv: -kv[1])[:40])

    def check(self):
        """The numbers of this client's checks, after its program state is
        freed (the reference's memory is not the program's)."""
        import torch
        from .check import Judge, judge, limits_of
        rec = self.rec
        self.vo = self.net = self.spans = None
        rec.vo = None
        gc.collect()
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()
        j = Judge(self.cfg_j, self.seq, self.seeds['weights'],
                  self.seeds['vo'], self.dev)
        t0 = time.monotonic()
        band = limits_of(self.cfg_j['name'])['keyframe_band']
        out = judge(j, rec, band=band)
        return dict(numbers=out, check_s=time.monotonic() - t0)


def main(rfd, wfd):
    """The client's loop, in a process forked from the run's parent:
    messages in on file descriptor rfd, answers out on wfd. Whatever else
    it prints goes to standard error."""
    proto = os.fdopen(wfd, 'w', buffering=1)
    inp = os.fdopen(rfd, 'r')
    sys.stdout = sys.stderr

    def send(obj):
        proto.write(json.dumps(obj) + '\n')

    t0 = time.monotonic()
    # the parent imported PyTorch before it forked this process
    import torch
    import dpvo_torch.runtime  # noqa: F401
    msg = json.loads(inp.readline())
    msg.update(t_msg=time.monotonic(), imports_s=time.monotonic() - t0)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 1:
        send(dict(cuda=count))
        return 0
    c = Client(msg)
    send(dict(cuda=count, kind=torch.cuda.get_device_name(c.dev),
              prepared_s=time.monotonic() - t0))
    for line in inp:
        m = json.loads(line)
        cmd = m['cmd']
        if cmd == 'warm':
            c.warm_up()
            send(dict(ready=True, setup_s=time.monotonic() - t0,
                      parts=c.setup, pace=c.pace,
                      memory_setup_bytes=c._peak()))
        elif cmd == 'go':
            send(c.window(m))
        elif cmd == 'trace':
            send(c.trace(*m['interval']))
        elif cmd == 'gaps':
            send(c.gaps(m['gaps']))
        elif cmd == 'solo':
            send(c.solo(m['frames']))
        elif cmd == 'check':
            send(c.check())
        elif cmd == 'exit':
            send(dict(bad_modules=bad_modules()))
            break
    return 0
