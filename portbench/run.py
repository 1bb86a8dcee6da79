"""The benchmark of dpvo_torch: one run of one workload of BENCHMARK.json.

    python3 -m portbench.run --workload dpvo-default.clients --seed 7 \
        --seconds 40 --trace 0

From the root of a checkout. The parent starts a builder of the
configuration's CUDA libraries (portbench.build, into the checkout's
build/), imports PyTorch once, and forks N client processes
(portbench.client; the cell's traffic mix gives N) that talk to it only
over a pair of pipes each. The parent makes no CUDA context, so each
client makes its own. While the clients build their networks and render
their frames, nvcc runs; then the clients warm up, loading the libraries,
and the parent releases them together and collects what they did by the
deadline.

With --trace 0 the last line of standard output is the end-to-end
metrics, with --trace 1 the per-layer ones (metrics/<name>.py read them):
the card's busy and idle time from every client's trace of one common
interval of the window, and each layer's device time from a trace of
client 0 alone once the window has closed, while the others wait. Every
run then checks what each client's timed path produced against the plain
reference (check.py) and prints each number beside its limit
(limits/<config>.json) as its last lines on standard error.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import select  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402

CACHE = spec.ROOT / 'build' / 'portbench'


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog='python3 -m portbench.run')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def smi(fields):
    """nvidia-smi's reading of `fields` for card 0, or its error."""
    try:
        out = subprocess.run(
            ['nvidia-smi', f'--query-gpu={fields}',
             '--format=csv,noheader', '-i', '0'], capture_output=True,
            text=True, timeout=20)
        return (out.stdout or out.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi: {e}'


class Clients:
    """The client processes, forked from this one once it has imported
    PyTorch (and before it touches CUDA), and the line protocol to them:
    one JSON object per line each way over a pair of pipes."""

    def __init__(self, n):
        from .client import main as client_main
        self.pids, self.out, self.fds = [], [], []
        ends = []
        sys.stdout.flush()
        sys.stderr.flush()
        for _ in range(n):
            r_in, w_in = os.pipe()          # parent -> client
            r_out, w_out = os.pipe()        # client -> parent
            pid = os.fork()
            if pid == 0:
                code = 1
                try:
                    for fd in ends + [w_in, r_out]:
                        os.close(fd)
                    os.dup2(2, 1)           # stray prints go to stderr
                    code = client_main(r_in, w_out) or 0
                except BaseException:
                    import traceback
                    traceback.print_exc()
                finally:
                    sys.stderr.flush()
                    os._exit(code)
            os.close(r_in)
            os.close(w_out)
            ends += [w_in, r_out]
            self.pids.append(pid)
            self.out.append(os.fdopen(w_in, 'w', buffering=1))
            self.fds.append(r_out)
        self.codes = [None] * n

    def send(self, msgs):
        """msgs[i] to client i (to the first len(msgs) clients)."""
        for f, m in zip(self.out, msgs):
            f.write(json.dumps(m) + '\n')
            f.flush()

    def send_all(self, m):
        self.send([m] * len(self.pids))

    def gather(self, timeout, only=None):
        """One message from every client (or from those in `only`), in
        client order."""
        want = range(len(self.pids)) if only is None else only
        got = [None if i in want else {} for i in range(len(self.pids))]
        bufs = [b''] * len(self.pids)
        end = time.monotonic() + timeout
        while any(g is None for g in got):
            wait = end - time.monotonic()
            if wait <= 0:
                raise TimeoutError('clients did not answer in time')
            ready, _, _ = select.select(
                [fd for i, fd in enumerate(self.fds) if got[i] is None],
                [], [], wait)
            for fd in ready:
                i = self.fds.index(fd)
                chunk = os.read(fd, 1 << 20)
                if not chunk:
                    raise RuntimeError(f'client {i} ended (exit code '
                                       f'{self._wait(i, 60)})')
                bufs[i] += chunk
                if b'\n' in bufs[i]:
                    got[i] = json.loads(bufs[i].split(b'\n', 1)[0])
        return [got[i] for i in want]

    def _wait(self, i, timeout):
        """Client i's exit code, killing it if it has not ended within
        `timeout` s."""
        end = time.monotonic() + timeout
        while self.codes[i] is None:
            pid, status = os.waitpid(self.pids[i], os.WNOHANG)
            if pid:
                self.codes[i] = os.waitstatus_to_exitcode(status)
            elif time.monotonic() >= end:
                os.kill(self.pids[i], signal.SIGKILL)
                end = float('inf')
            else:
                time.sleep(0.01)
        return self.codes[i]

    def close(self, timeout=60):
        """Wait for every client (killing one that does not end in
        `timeout` s); their exit codes."""
        for f in self.out:
            if not f.closed:
                f.close()
        for fd in self.fds:
            try:
                os.close(fd)
            except OSError:
                pass
        self.fds = [-1] * len(self.fds)
        return [self._wait(i, timeout) for i in range(len(self.pids))]

    def kill(self):
        for i, pid in enumerate(self.pids):
            if self.codes[i] is None:
                os.kill(pid, signal.SIGKILL)


def read_metric(name, facts):
    """The per-layer or end-to-end metric `name` from its reader,
    metrics/<name>.py: read(facts) returns a number or None."""
    path = spec.HERE / 'metrics' / f'{name}.py'
    s = importlib.util.spec_from_file_location(f'portbench_metric_{name}',
                                               path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read(facts)


def gaps_of(busy_lists, lo, hi):
    """Intervals of [lo, hi] in which no client's device work ran."""
    from .trace import union
    iv = union([tuple(x) for b in busy_lists for x in b])
    gaps, at = [], lo
    for a, b in iv:
        if a > at:
            gaps.append([at, a])
        at = max(at, b)
    if at < hi:
        gaps.append([at, hi])
    return gaps


def traced(clients, win, traffic, n):
    """The trace facts of a traced run and its breakdown. The card's busy
    time comes from the interval every client traced in the window: the
    union of their device intervals, since a kernel that the time slicer
    preempts stays open in its own trace while another context runs. Each
    layer's device time comes from client 0 alone, traced for one pass of
    its sequence (traffic.cycle) once the window has closed while the
    others wait. The breakdown: the device ops that took most time in client 0's
    frames, and the window's idle gaps by what the hosts were doing."""
    tc = traffic['trace']
    lo = max(w['traced'][0] for w in win) + tc['margin_s']
    hi = min(w['traced'][1] for w in win) - tc['margin_s']
    log(f'profiler seconds per client (warm-up start, stop; start, stop in '
        f'the window): {[w["profiler_s"] for w in win]}')
    if hi - lo < tc['min_s']:
        raise RuntimeError(f'the clients traced {hi - lo:.3f} s together, '
                           f'under {tc["min_s"]} s')
    clients.send_all(dict(cmd='trace', interval=[lo, hi]))
    tr = clients.gather(600)
    gaps = gaps_of([t['busy'] for t in tr], lo, hi)
    clients.send_all(dict(cmd='gaps', gaps=gaps))
    host = clients.gather(300)
    summed = sum(sum(y - x for x, y in t['busy']) for t in tr)
    busy_s = (hi - lo) - sum(b - a for a, b in gaps)
    log(f'traced interval {hi - lo:.4f} s: device busy (union over clients) '
        f'{busy_s:.6f} s; summed over clients {summed:.6f} s '
        f'({summed / (hi - lo):.4f} of the interval; over 1: preempted '
        f'kernels overlap), per client '
        f'{[round(sum(y - x for x, y in t["busy"]), 6) for t in tr]}')
    from .traffic import cycle
    clients.send([dict(cmd='solo', frames=cycle(traffic))])
    solo = clients.gather(600, only=[0])[0]
    log(f'client 0 alone: {solo["frames"]} frames in {solo["seconds"]:.4f} '
        f's, device busy {solo["busy_s"]:.6f} s; per span (calls, device '
        f's, ops): ' + ', '.join(
            f'{k} ({v["calls"]}, {v["device_s"]:.6f}, {v["ops"]})'
            for k, v in solo['spans'].items()))
    idle = {}
    for h in host:
        for k, v in h['host'].items():
            idle[k] = idle.get(k, 0.0) + v / n

    def top(d):
        return sorted(([k[:64], v] for k, v in d.items()),
                      key=lambda kv: -kv[1])[:10]
    facts = dict(interval_s=hi - lo, busy_s=busy_s,
                 frames_in=sum(t['frames_in'] for t in tr), solo=solo,
                 enqueue_s=[d for t in tr for d in t['enqueue_s']],
                 fps_pre=sum(t['fps_pre'] for t in tr))
    return facts, dict(device_ops=top(dict(solo['by_name'])),
                       idle_gaps=top(idle))


def main(argv=None):
    args = parse(argv)
    bench = spec.benchmark()
    cell, config, traffic, metrics = spec.resolve(bench, args.workload)
    n = traffic['clients']
    os.environ.update(TRITON_CACHE_DIR=str(CACHE / 'triton'),
                      TORCH_EXTENSIONS_DIR=str(CACHE / 'torch_extensions'),
                      OMP_NUM_THREADS='1', MKL_NUM_THREADS='1', USE_FLAX='0')
    # nvcc, where the libraries are not built yet, runs while this process
    # imports PyTorch and the clients set up
    builder = subprocess.Popen([sys.executable, '-m', 'portbench.build',
                                *config['kernels']], cwd=spec.ROOT)
    clients = None
    try:
        t = time.monotonic()
        import torch  # noqa: F401
        import scipy.ndimage  # noqa: F401
        from . import check, traffic as _  # noqa: F401
        log(f'parent imports {time.monotonic() - t:.3f} s')
        clients = Clients(n)
        return run(args, cell, config, traffic, metrics, n, clients, builder)
    finally:
        if clients is not None:
            clients.close()
        if builder.poll() is None:
            builder.kill()
        builder.wait()


def run(args, cell, config, traffic, metrics, n, clients, builder):
    clients.send([dict(config=config, traffic=traffic, seed=args.seed,
                       index=i, trace=args.trace) for i in range(n)])
    cores = len(os.sched_getaffinity(0))
    log(f'portbench: {args.workload}: {n} clients on 1 card, {cores} '
        f'usable host cores, seed {args.seed}, {args.seconds} s, trace '
        f'{args.trace}')
    log('card before: ' + smi('name,power.limit,power.draw,clocks.sm,'
                              'clocks.max.sm,temperature.gpu'))
    if builder.wait(timeout=1100):
        log(f'portbench: the library build failed ({builder.returncode})')
        clients.kill()
        return 2
    log(f'libraries built or found {time.monotonic() - T_START:.3f} s after '
        f'the command started')
    prep = clients.gather(1100)
    found = min(p['cuda'] for p in prep)
    if found < cell['chips']:
        log(f'portbench: this run needs {cell["chips"]} CUDA device(s); '
            f'found {found}')
        clients.kill()
        return 3
    kind = prep[0]['kind']
    log(f'clients prepared (network, runtime, frames) '
        f'{[round(p["prepared_s"], 3) for p in prep]} s after their start; '
        f'the card: {kind}; told to warm up '
        f'{time.monotonic() - T_START:.3f} s after the command started')
    clients.send_all(dict(cmd='warm'))
    ready = clients.gather(1100)
    for i, r in enumerate(ready):
        log(f'client {i}: set-up {r["setup_s"]:.3f} s {r["parts"]}, '
            f'device memory after warm-up {r["memory_setup_bytes"]}')
        if r['pace']:
            log(f'host pace (client 0): {r["pace"][0]:.3f} ms pure '
                f'Python loop, {r["pace"][1]:.3f} us per launch')
    t0 = time.monotonic() + 0.25
    deadline = t0 + args.seconds
    go = dict(cmd='go', t0=t0, deadline=deadline)
    tc = traffic['trace']
    a = t0 + tc['start_share'] * args.seconds
    b = min(a + tc['seconds'], deadline - 0.05)
    if args.trace:
        go['trace'] = [a, b]
    clients.send_all(go)
    setup_s = t0 - T_START
    win = clients.gather(args.seconds + 300)
    log('card just after the window: ' + smi(
        'power.draw,power.limit,clocks.sm,temperature.gpu'))
    frames = sum(w['frames'] for w in win)
    elapsed = max(w['t_end'] for w in win) - t0
    peaks = [w['memory_peak_bytes'] for w in win]
    log(f'window: frames per client {[w["frames"] for w in win]}, '
        f'{elapsed:.4f} s to the last sync, peak device memory per '
        f'client {peaks}')
    facts = dict(clients=n, seconds=args.seconds, frames=frames,
                 elapsed_s=elapsed, setup_s=setup_s, config=config,
                 trace=None)
    breakdown = None
    if args.trace:
        facts['trace'], breakdown = traced(clients, win, traffic, n)
    clients.send_all(dict(cmd='check'))
    checks = clients.gather(600)
    clients.send_all(dict(cmd='exit'))
    bye = clients.gather(120)
    codes = clients.close()
    bad = set(spec.FORBIDDEN & {m.split('.')[0] for m in list(sys.modules)})
    for w in win + bye:
        bad |= set(w['bad_modules'])
    if bad:
        log(f'portbench: modules that may not be loaded were loaded: '
            f'{sorted(bad)}')
        return 4
    if any(codes):
        log(f'portbench: client exit codes {codes}')
        return 5

    from .check import limits_of, verdict
    numbers = {}
    for i, c in enumerate(checks):
        log(f'client {i} check ({c["check_s"]:.3f} s): '
            + ', '.join(f'{k} {v!r}' for k, v in sorted(c['numbers'].items())))
        for k, v in c['numbers'].items():
            numbers[k] = max(numbers.get(k, v), v)
    correct, rows = verdict(numbers, limits_of(config['name'])['numbers'])

    names = [m['name'] for m in metrics['per_layer' if args.trace else
                                          'end_to_end']]
    out = {}
    for m in metrics['per_layer' if args.trace else 'end_to_end']:
        v = read_metric(m['name'], facts)
        if v is not None:
            out[m['name']] = dict(value=v, unit=m['unit'])
    log(f'metrics: {json.dumps(out)} (of {names})')
    if args.trace and all(k in out for k in ('patchify_ms', 'update_ms',
                                             'ba_ms', 'busy_ms')):
        parts = sum(out[k]['value'] for k in ('patchify_ms', 'update_ms',
                                              'ba_ms'))
        log(f'layers: patchify_ms + update_ms + ba_ms = {parts!r} against '
            f'busy_ms {out["busy_ms"]["value"]!r} '
            f'({"within" if parts <= out["busy_ms"]["value"] else "OVER"})')
    device = dict(platform='gpu', kind=kind, count=cell['chips'],
                  memory_peak_bytes=sum(peaks))
    if args.trace:
        device.update(busy_s=facts['trace']['busy_s'],
                      window_s=facts['trace']['interval_s'])
    shown = [(k, v, lim) for k, v, lim in rows if lim is not None]
    result = dict(correct=correct, attempted=frames, failed=0, metrics=out,
                  device=device)
    if breakdown:
        result['breakdown'] = breakdown
    result['checks'] = {k: dict(value=v, limit=lim) for k, v, lim in shown}
    for k, v, lim in shown:
        log(f'check {k}: {v!r} (limit {lim!r})'
            f'{"" if v <= lim else "  FAILED"}')
    log(f'correct: {correct}')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
