"""Smoke run of the PyTorch / CUDA port (dpvo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. environment: a CUDA device must exist; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles dpvo_torch/csrc/corr_onepass.cu with nvcc;
  3. kernel vs plain: the correlation kernel against its plain PyTorch
     version at the main path's shapes (E = 49,152 edges, 36 frames of
     120x160 and 30x40 bf16 maps), plus the fast.yaml row layout (M = 48),
     with the times of both (CUDA events, median of 20);
  4. main path: dpvo_torch.runtime.DPVO with config/default.yaml at 640x480
     and the full-width VONet (artifacts/micro_vonet.npz), 40 synthetic
     frames + terminate(); the kernel's launch count must cover every update
     iteration. Then the same runtime on CUDA and on the CPU (plain
     correlation) at 64x96 must agree.
The last two lines of stdout are a JSON line with the kernel's numbers and
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, 'config', 'default.yaml')
WEIGHTS = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def synthetic_frames(n, H, W, seed):
    """A seeded smooth RGB texture seen through a crop that moves 3 px right
    and 2 px down per frame."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    tex = gaussian_filter(rng.rand(H + 2 * n + 8, W + 3 * n + 8, 3),
                          (2.0, 2.0, 0))
    tex = (tex - tex.min()) / np.ptp(tex) * 255.0
    return [tex[2 * t:2 * t + H, 3 * t:3 * t + W].astype(np.uint8)
            for t in range(n)]


def corr_case(E, F, H1, W1, Ng, seed, kk=None):
    """Seeded f32 maps (callers round them to bf16) and coords covering the
    interior, all four borders, negative coords and coords far outside the
    map; 3x3 pixel grids with a jittered spread of up to ~3 px."""
    rng = np.random.RandomState(seed)
    gmap = rng.randn(Ng, 3, 3, 128).astype(np.float32)
    f1 = rng.randn(F, H1, W1, 128).astype(np.float32)
    f2 = rng.randn(F, H1 // 4, W1 // 4, 128).astype(np.float32)
    q = E // 6
    cx = np.concatenate([rng.uniform(4, W1 - 5, E - 5 * q),
                         rng.uniform(-6, 3, q), rng.uniform(W1 - 3, W1 + 6, q),
                         rng.uniform(4, W1 - 5, 2 * q),
                         rng.uniform(-3 * W1, 4 * W1, q)])
    cy = np.concatenate([rng.uniform(4, H1 - 5, E - 5 * q),
                         rng.uniform(4, H1 - 5, 2 * q),
                         rng.uniform(-6, 3, q), rng.uniform(H1 - 3, H1 + 6, q),
                         rng.uniform(-3 * H1, 4 * H1, q)])
    sp = rng.uniform(0.5, 1.5, (E, 1, 1))
    off = np.linspace(-1.0, 1.0, 3)
    gx = cx[:, None, None] + sp * off[None, None, :] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    gy = cy[:, None, None] + sp * off[None, :, None] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    coords = np.stack([gx, gy], -1).astype(np.float32)
    if kk is None:
        kk = rng.randint(0, Ng, E)
    jj = np.sort(rng.randint(0, F, E))       # pairs arrive sorted by target
    return gmap, f1, f2, coords, kk.astype(np.int32), jj.astype(np.int32)


def time_ms(fn, reps=20):
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_vs_plain(dev, E, F, H1, W1, Ng, nv, seed, kk=None, timed=False):
    """Kernel (bf16 maps) vs the plain version on the same inputs, both with
    f32 output. Tolerance: |kernel - plain| <= 1e-4 * max|plain| -- both sum
    the same 128 f32 products per tap, in another order. Edges >= nv must be
    exact zeros. The bf16 output (the main path's) must be within one bf16
    rounding of it. Returns (max_abs_err, kernel_ms, plain_ms)."""
    import torch
    from dpvo_torch.ops import corr_onepass
    from dpvo_torch.ops.corr import corr_two_level as corr_plain
    gmap, f1, f2, coords, kk, jj = corr_case(E, F, H1, W1, Ng, seed, kk)
    maps = [torch.from_numpy(a).to(dev).to(torch.bfloat16)
            for a in (gmap, f1, f2)]
    co, kk_t, jj_t = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))

    out = corr_onepass.corr_two_level(*maps, co, kk_t, jj_t, nv=nv,
                                      out_dtype=torch.float32)
    ref = corr_plain(*maps, co, kk_t, jj_t, nv=nv, out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(out.shape == (E, 7, 7, 3, 3, 2), f'kernel output shape {out.shape}')
    check(bool(torch.isfinite(out).all()), 'kernel output not finite')
    scale = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    check(err <= 1e-4 * scale, f'kernel vs plain: max |err| {err} > '
          f'1e-4 * {scale}')
    check(bool((out[nv:] == 0).all()), 'nonzero output past nv')
    out16 = corr_onepass.corr_two_level(*maps, co, kk_t, jj_t, nv=nv,
                                        out_dtype=torch.bfloat16)
    err16 = (out16.float() - ref).abs() - 2 ** -8 * ref.abs()
    check(err16.max().item() <= 1e-4 * scale, 'bf16 output off by more '
          'than one rounding')
    print(f'  E={E} F={F} L1={H1}x{W1} nv={nv}: max|kernel-plain| = {err!r} '
          f'(max|plain| = {scale!r}, bound 1e-4 * max|plain|)', flush=True)
    if not timed:
        return err, None, None
    args = (*maps, co, kk_t, jj_t)
    k_ms = time_ms(lambda: corr_onepass.corr_two_level(
        *args, nv=nv, out_dtype=torch.bfloat16))
    p_ms = time_ms(lambda: corr_plain(*args, nv=nv, out_dtype=torch.bfloat16))
    print(f'  time (bf16 out, median of 20): kernel {k_ms!r} ms, '
          f'plain {p_ms!r} ms', flush=True)
    return err, k_ms, p_ms


def device_time(trace_path):
    """(busy ms, {kernel name: ms}, device op count) from a chrome trace:
    the union of GPU kernel / memcpy / memset intervals, the summed time of
    each name, and how many such ops ran."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and e.get('cat') in
                  ('kernel', 'gpu_memcpy', 'gpu_memset')]
    by_name = {}
    for e in events:
        by_name[e['name']] = by_name.get(e['name'], 0.0) + e.get('dur', 0) / 1e3
    iv = sorted((e['ts'], e['ts'] + e.get('dur', 0)) for e in events)
    busy, lo, hi = 0.0, None, None
    for a, b in iv:
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    return busy / 1e3, by_name, len(events)


def main_path(dev, n_frames=40):
    """DPVO at 640x480 with default.yaml and the full-width VONet."""
    import torch
    from dpvo_torch.config import cfg as base_cfg
    from dpvo_torch.ops import corr_onepass
    from dpvo_torch.runtime import DPVO

    H, W = 480, 640
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    frames = synthetic_frames(n_frames, H, W, seed=0)
    intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    slam = DPVO(cfg, WEIGHTS, ht=H, wd=W, seed=0, device=dev)
    slam.force_accept = True

    corr_onepass.launches = 0
    walls = []
    trace_frames = range(n_frames - 10, n_frames)
    with tempfile.TemporaryDirectory() as tmp:
        from torch.profiler import ProfilerActivity, profile
        prof = None
        for t, img in enumerate(frames):
            if t == trace_frames.start:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                t_trace = time.perf_counter()
            t0 = time.perf_counter()
            slam(t, img, intr)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        wall_trace = time.perf_counter() - t_trace
        prof.__exit__(None, None, None)
        path = f'{tmp}/trace.json'
        prof.export_chrome_trace(path)
        busy, by_name, n_ops = device_time(path)
        poses, tstamps = slam.terminate()
        torch.cuda.synchronize()
    launches = corr_onepass.launches

    expected = 12 + (n_frames - 8) + 12     # bootstrap + 1/frame + refine
    check(poses.shape == (n_frames, 7), f'poses shape {poses.shape}')
    check(np.isfinite(poses).all(), 'poses not finite')
    check(np.allclose(np.linalg.norm(poses[:, 3:], axis=-1), 1.0, atol=1e-3),
          'quaternions not unit')
    for name, t in slam.st.tensors().items():
        check(t.device.type == 'cuda', f'VOState.{name} on {t.device}')
    check(launches >= expected, f'kernel launched {launches} times, '
          f'expected >= {expected}')

    # frames 10 .. trace start run without the profiler, whose host-side
    # tracing slows every launch: they give the wall time and frames/s
    steady = walls[10:trace_frames.start]
    wall_ms = 1e3 * float(np.median(steady))
    q25, q75 = (1e3 * float(q) for q in np.percentile(steady, [25, 75]))
    print(f'  {n_frames} frames + terminate(): keyframes n = {slam.n}, '
          f'kernel launches = {launches} (update iterations = {expected})')
    print(f'  steady-state wall per frame (median of frames 10..'
          f'{trace_frames.start - 1}, host clock with sync): '
          f'{wall_ms!r} ms (quartiles {q25!r}, {q75!r}) -> '
          f'{1e3 / wall_ms!r} frames/s')
    if busy > 0:
        nf = len(trace_frames)
        busy_ms = busy / nf
        print(f'  device busy per frame (profiler, frames '
              f'{trace_frames.start}..{n_frames - 1}): {busy_ms!r} ms; '
              f'idle share of the unprofiled wall {1.0 - busy_ms / wall_ms!r}; '
              f'traced wall per frame {1e3 * wall_trace / nf!r} ms; '
              f'{n_ops / nf!r} device ops per frame, '
              f'{len(by_name)} distinct names')
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        for k, v in top:
            print(f'    {v / nf:8.4f} ms/frame  {k[:100]}')
        sys.stdout.flush()
    else:
        print('  device busy per frame: not measured (no device events in '
              'the profiler trace)', flush=True)
    return launches


def small_cpu_vs_cuda(dev):
    """The runtime at 64x96 on CUDA (kernel) and on the CPU (plain
    correlation), f32: the poses must agree (both compute the same f32 ops;
    sums run in another order, so the bound is 1e-3)."""
    import torch
    from dpvo_torch.config import cfg as base_cfg
    from dpvo_torch.runtime import DPVO

    H, W = 64, 96
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    cfg.PATCHES_PER_FRAME = 8
    cfg.BUFFER_SIZE = 64
    cfg.MIXED_PRECISION = False
    frames = synthetic_frames(16, H, W, seed=1)
    intr = np.array([60.0, 60.0, W / 2, H / 2], np.float32)
    out = []
    for d in (dev, 'cpu'):
        slam = DPVO(cfg, WEIGHTS, ht=H, wd=W, seed=0, device=d)
        slam.force_accept = True
        for t, img in enumerate(frames):
            slam(t, img, intr)
        out.append(slam.terminate()[0])
    err = float(np.abs(out[0] - out[1]).max())
    check(np.isfinite(out[0]).all(), 'small run: poses not finite')
    check(err <= 1e-3, f'small run: CUDA vs CPU poses differ by {err}')
    print(f'  64x96, 16 frames: max |pose CUDA - pose CPU| = {err!r}')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)

    print('[1/4] environment', flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} device(s): {name}')

    print('[2/4] build', flush=True)
    from dpvo_torch.ops import corr_onepass
    t0 = time.perf_counter()
    so = corr_onepass.build()
    print(f'  {so.name} in {time.perf_counter() - t0:.1f} s')
    for line in so.with_suffix('.log').read_text().splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ' + line.strip())

    print('[3/4] kernel vs plain', flush=True)
    err, k_ms, p_ms = kernel_vs_plain(dev, E=49152, F=36, H1=120, W1=160,
                                      Ng=36 * 96, nv=40013, seed=0,
                                      timed=True)
    M, G = 48, 320                  # fast.yaml: M = 48, 320 pair slots
    kk = (np.repeat(np.arange(G) % 36, M) * M + np.tile(np.arange(M), G))
    err48, _, _ = kernel_vs_plain(dev, E=M * G, F=36, H1=120, W1=160,
                                  Ng=36 * M, nv=300 * M, seed=1, kk=kk)
    corr_onepass.launches = 0

    print('[4/4] main path', flush=True)
    launches = main_path(dev)
    small_cpu_vs_cuda(dev)

    print(smi)
    print(json.dumps({'kernels': [{
        'name': 'corr_onepass', 'route': 'cuda',
        'source': 'dpvo_torch/csrc/corr_onepass.cu',
        'replaces': 'dpvo_tpu/ops/corr_onepass.py:196',
        'launches': launches, 'max_abs_err': max(err, err48),
        'ms': k_ms, 'plain_ms': p_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
