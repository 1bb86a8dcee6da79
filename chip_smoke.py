"""Smoke run of the PyTorch / CUDA port (dpvo_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. environment: a CUDA device must exist; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles dpvo_torch/csrc/corr_onepass.cu (K1),
     dpvo_torch/csrc/corr_fused.cu (K2 planes, K3 tap select) and
     dpvo_torch/csrc/corr_probes.cu (the probes K4-K8) with nvcc, one
     process per source, started together; prints ptxas's register and
     spill lines of each kernel, K1's threads, shared memory and blocks
     per SM for bf16 and f32 maps, and K6 dots' persistent launch shape
     (grid, threads, dynamic shared memory, registers, blocks per SM and
     its ring);
  3. kernels vs plain, at the main paths' shapes (E = 49,152 edges, 36
     frames of 120x160 and 30x40 bf16 maps): K1 (plus the fast.yaml row
     layout, M = 48; the pixels per branch and level of its union-box rule,
     both branches must run, and the rows it stages), K2, K3 (also on the
     pixels whose spread overflows the window, which it must zero), and
     K2 + K3 against the exact correlation on edges whose spread fits the
     window, with the times of kernel and plain (CUDA events, median of 20)
     and each kernel's roofline bound;
  4. DeviceVO main path: dpvo_torch.runtime.DPVO with config/default.yaml at
     640x480 and the full-width VONet (artifacts/micro_vonet.npz), 40
     synthetic frames + terminate(); K1 must cover every update iteration;
     wall, device busy, idle share and top kernels from a profiler trace;
  5. hybrid main path: the same with CENTROID_SEL_STRAT=GRADIENT_BIAS
     (HybridVO) and DPVO_CORR_IMPL=fused_k, 40 frames + terminate(); K2 and
     K3 must cover every update iteration; the same measurements;
  6. DeviceVO with DPVO_CORR_IMPL=fused_k, 12 frames + terminate() at
     640x480: K2 and K3 launch there too;
  7. CUDA vs CPU: DeviceVO at 64x96 (K1 vs plain) and HybridVO at
     256x320 with onepass, its default (K1), and with fused_k (K2 + K3),
     each in f32 and in bf16 (MIXED_PRECISION: K1's box kernel, K2 / K3 on
     bf16 maps), each against its plain versions: poses agree and the CUDA
     run launched its kernels;
  8. correlation probes: the four entry points dpvo_torch.scripts.
     micro_fused_v2 (K4, K5), micro_corr_floor (K6), micro_onepass_dma (K7)
     and micro_kernel_variants (K8) at their scripts' sizes, launch counts
     set to 0 just before each and read just after; each probe kernel
     within its bound of its plain version, launched, timed beside its
     plain version, its bound and (K6 dots) one torch.bmm, timed in turns
     with the kernel (kernel / library ratio printed).
The last two lines of stdout are a JSON line with the kernels' numbers and
{"ok": true, "device": {...}}.
"""
import itertools
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
    map; 3x3 pixel grids with a jittered spread of up to ~3 px, except the
    first E // 16 (interior) edges, whose x and y spreads reach ~18 px: they
    overflow the fused correlation's windows (y spread > 4 px or x spread
    > 5 px at a level) at one level or both, and the select zeroes those
    pixels."""
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
    spx = rng.uniform(0.5, 1.5, (E, 1, 1))
    spy = spx.copy()
    n_ov = E // 16
    spx[:n_ov], spy[:n_ov] = rng.uniform(0.5, 9.0, (2, n_ov, 1, 1))
    off = np.linspace(-1.0, 1.0, 3)
    gx = cx[:, None, None] + spx * off[None, None, :] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    gy = cy[:, None, None] + spy * off[None, :, None] + \
        rng.uniform(-.3, .3, (E, 3, 3))
    coords = np.stack([gx, gy], -1).astype(np.float32)
    if kk is None:
        kk = rng.randint(0, Ng, E)
    jj = np.sort(rng.randint(0, F, E))       # pairs arrive sorted by target
    return gmap, f1, f2, coords, kk.astype(np.int32), jj.astype(np.int32)


def kernel_vs_plain(dev, E, F, H1, W1, Ng, nv, seed, kk=None, timed=False):
    """Kernel (bf16 maps) vs the plain version on the same inputs, both with
    f32 output. Tolerance: |kernel - plain| <= 1e-4 * max|plain| -- both sum
    the same 128 f32 products per tap, in another order. Edges >= nv must be
    exact zeros. The bf16 output (the main path's) must be within one bf16
    rounding of it. Both of the kernel's branches (taps from the union box,
    taps from global memory for windows that overflow it; box_fits) must
    run on the live edges and be within the bound on their own. Returns
    (max_abs_err, kernel_ms, plain_ms, (bound_ms, side)); the last three
    None unless timed."""
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
    fits = corr_onepass.box_fits(co[:nv], H1, W1, H1 // 4, W1 // 4)
    d = (out[:nv] - ref[:nv]).abs()
    for lvl in range(2):
        n_fit = int(fits[..., lvl].sum())
        n_ovf = fits[..., lvl].numel() - n_fit
        check(n_fit > 0 and n_ovf > 0, f'level {lvl + 1}: pixels in the box '
              f'{n_fit}, overflowing {n_ovf}: a branch did not run')
        errs = [d[..., lvl].masked_fill(~m[:, None, None], 0).max().item()
                for m in (fits[..., lvl], ~fits[..., lvl])]
        print(f'  level {lvl + 1}: {n_fit} live pixels from the union box '
              f'(max|kernel-plain| {errs[0]!r}), {n_ovf} overflowing it, '
              f'from global memory ({errs[1]!r})', flush=True)
    rows = corr_onepass.box_rows(co[:nv], H1, W1, H1 // 4, W1 // 4)
    staged = (int(rows.sum()) + nv * 9) * 128 * 2
    print(f'  rows staged in shared memory: {rows.float().mean(0).tolist()} '
          f'per live edge at L1 / L2, with the g rows {staged / nv / 1e3!r} '
          f'KB per live edge, {staged / 1e9!r} GB per call', flush=True)
    out16 = corr_onepass.corr_two_level(*maps, co, kk_t, jj_t, nv=nv,
                                        out_dtype=torch.bfloat16)
    err16 = (out16.float() - ref).abs() - 2 ** -8 * ref.abs()
    check(err16.max().item() <= 1e-4 * scale, 'bf16 output off by more '
          'than one rounding')
    print(f'  E={E} F={F} L1={H1}x{W1} nv={nv}: max|kernel-plain| = {err!r} '
          f'(max|plain| = {scale!r}, bound 1e-4 * max|plain|)', flush=True)
    if not timed:
        return err, None, None, None
    from dpvo_torch.scripts._common import time_ms
    args = (*maps, co, kk_t, jj_t)
    k_ms = time_ms(lambda: corr_onepass.corr_two_level(
        *args, nv=nv, out_dtype=torch.bfloat16))
    p_ms = time_ms(lambda: corr_plain(*args, nv=nv, out_dtype=torch.bfloat16))
    bound = k1_bound(*maps, co, kk_t, jj_t, nv)
    print(f'  time (bf16 out, median of 20): kernel {k_ms!r} ms, '
          f'plain {p_ms!r} ms; bound {bound[0]!r} ms ({bound[1]})',
          flush=True)
    return err, k_ms, p_ms, bound


def k1_bound(gmap, f1, f2, co, kk, jj, nv):
    """K1's roofline bound (ms, side) for this run: the g rows, map pixels
    (each pixel's 8x8 integer taps at both levels), coords, kk and jj of
    the nv live edges read once, the bf16 output of all E edges written
    once; the 8x8 tap dots and the bilinear combination of the live
    edges."""
    import torch
    from dpvo_torch.scripts import _common as cm
    E = co.shape[0]
    r = torch.arange(8, device=co.device) - 3
    nb = cm.nbytes(co[:nv], kk[:nv], jj[:nv]) + E * 7 * 7 * 9 * 2 * 2
    nb += len(set(kk[:nv].tolist())) * 9 * 128 * gmap.element_size()
    for fm, c in ((f1, co[:nv]), (f2, co[:nv] / 4.0)):
        xi = c[..., 0].floor().long().reshape(nv, 9, 1, 1)
        yi = c[..., 1].floor().long().reshape(nv, 9, 1, 1)
        nb += cm.map_bytes(jj[:nv], yi + r[:, None], xi + r, *fm.shape[:3])
    flops = 2 * nv * 9 * 64 * 128 * 2 + nv * 9 * 49 * 7 * 2
    return cm.bound_ms(nb, flops)


def fused_vs_plain(dev, E, F, H1, W1, Ng, seed):
    """K2 and K3 against their plain versions, and K2 + K3 against the
    exact correlation, on the same inputs (bf16 maps). Bounds:
      * K2 vs plain: both sum 128 f32 products per entry in another order,
        then round to bf16: |err| <= 2^-7 |plain| + 1e-5 max|plain| (the
        second term for entries that cancel to near zero);
      * K3 vs plain: the same f32 operations (no FMA contraction in either)
        on the same planes: <= 1e-6 max|plain|;
      * K2 + K3 vs the exact correlation (ops/corr.py, f32) on edges whose
        3x3 spread fits the windows: one bf16 rounding of the plane entries,
        <= 2^-8 max|plane| + 1e-5 max|exact|.
    Returns ((K2 err, ms, plain ms, bound), (K3 err, ms, plain ms, bound)),
    each bound (ms, side) for this run's bytes and operations."""
    import torch
    from dpvo_torch.ops import corr_fused as cf
    from dpvo_torch.ops.corr import corr_two_level as corr_exact
    gmap, f1, f2, coords, kk, jj = corr_case(E, F, H1, W1, Ng, seed)
    g, f1, f2 = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
                 for a in (gmap, f1, f2))
    co, kk_t, jj_t = (torch.from_numpy(a).to(dev) for a in (coords, kk, jj))
    g9 = g.reshape(Ng, 9, 128)
    H2, W2 = f2.shape[1:3]
    w1 = cf.window_base(co, H1, W1, 8)
    w2 = cf.window_base(co / 4.0, H2, W2, 4)
    pargs = (g9, f1, f2, kk_t, jj_t, w1[4], w1[5], w2[4], w2[5])

    p1, p2 = cf.planes(*pargs)
    r1, r2 = cf.planes_plain(*pargs)
    torch.cuda.synchronize()
    err2 = 0.0
    for got, ref in ((p1, r1), (p2, r2)):
        got, ref = got.float(), ref.float()
        check(bool(torch.isfinite(got).all()), 'K2 output not finite')
        d = (got - ref).abs()
        bound = 2 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
        check(bool((d <= bound).all()), f'K2 vs plain: {d.max().item()} '
              f'over the bound (max|plain| {ref.abs().max().item()})')
        err2 = max(err2, d.max().item())
    print(f'  K2 planes: max|kernel-plain| = {err2!r} (bound 2^-7 |plain| + '
          f'1e-5 max|plain|)', flush=True)

    def sel_args(plane, w, H, W):
        xi, yi, fx, fy, _, _, oy, ox = w
        return plane, yi, xi, fy, fx, oy, ox, H, W

    sargs = [sel_args(p1, w1, H1, W1), sel_args(p2, w2, H2, W2)]
    # pixels whose 8x8 tap block does not fit the window (oy, ox >= 0
    # always): K3's explicit zeroing branch
    over = [(w[6] > wy - 8) | (w[7] > wx - 8)
            for w, wy, wx in ((w1, cf.WY, cf.WX), (w2, cf.WY2, cf.WX2))]
    err3, scale3 = 0.0, 0.0
    sel = []
    for lvl, (a, ov) in enumerate(zip(sargs, over), 1):
        got = cf.select_taps(*a)
        ref = cf.select_plain(*a)
        torch.cuda.synchronize()
        check(got.shape == (E, 7, 7, 3, 3), f'K3 output shape {got.shape}')
        scale = ref.abs().max().item()
        d = (got - ref).abs().max().item()
        check(d <= 1e-6 * scale, f'K3 vs plain: {d} > 1e-6 * {scale}')
        # (E, dx, dy, py, px) -> (E, 9 pixels, 49 taps)
        per_pix = got.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
        ref_pix = ref.permute(0, 3, 4, 1, 2).reshape(E, 9, 49)
        n_ov = int(ov.sum())
        d_ov = (per_pix - ref_pix)[ov].abs().max().item()
        check(n_ov > 0, f'level {lvl}: no pixel overflows its window')
        check(d_ov <= 1e-6 * scale and not per_pix[ov].any(),
              f'level {lvl}: K3 does not zero the overflowing pixels '
              f'(max|kernel-plain| there {d_ov})')
        print(f'  K3 level {lvl}: {n_ov} of {E * 9} pixels overflow the '
              f'window, max|kernel-plain| on them = {d_ov!r} (all zero)',
              flush=True)
        err3, scale3 = max(err3, d), max(scale3, scale)
        sel.append(got)
    print(f'  K3 select (both levels): max|kernel-plain| = {err3!r} '
          f'(max|plain| = {scale3!r}, bound 1e-6 * max|plain|)', flush=True)

    # K2 + K3 against the exact correlation where every pixel's 8x8 block
    # fits its window at both levels
    fits = ~(over[0] | over[1]).any(1)
    c1, c2 = cf.corr_fused(g, f1, f2, co, kk_t, jj_t)
    ex = corr_exact(g, f1, f2, co, kk_t, jj_t, out_dtype=torch.float32)
    torch.cuda.synchronize()
    check(torch.equal(c1, sel[0]) and torch.equal(c2, sel[1]),
          'corr_fused differs from its own K2 + K3 launches')
    pmax = max(p1.float().abs().max().item(), p2.float().abs().max().item())
    emax = ex.abs().max().item()
    d = (torch.stack([c1, c2], -1) - ex)[fits].abs().max().item()
    bound = 2 ** -8 * pmax + 1e-5 * emax
    check(d <= bound, f'K2 + K3 vs exact: {d} > {bound}')
    print(f'  K2 + K3 vs exact correlation on {int(fits.sum())} of {E} '
          f'edges (spread fits the windows): max|err| = {d!r} (bound '
          f'2^-8 max|plane| + 1e-5 max|exact| = {bound!r})', flush=True)

    from dpvo_torch.scripts import _common as cm
    k2_ms = cm.time_ms(lambda: cf.planes(*pargs))
    p2_ms = cm.time_ms(lambda: cf.planes_plain(*pargs))
    k3_ms = cm.time_ms(lambda: [cf.select_taps(*a) for a in sargs])
    p3_ms = cm.time_ms(lambda: [cf.select_plain(*a) for a in sargs])
    n1, n2 = cf.WY * cf.WX, cf.WY2 * cf.WX2
    b2 = cm.bound_ms(
        len(set(kk)) * 9 * 128 * 2 + cm.nbytes(*pargs[3:], p1, p2) +
        cm.map_bytes(jj_t, *cm.window_yx(w1[4], w1[5], cf.WX, n1), F, H1, W1)
        + cm.map_bytes(jj_t, *cm.window_yx(w2[4], w2[5], cf.WX2, n2), F, H2,
                       W2), 2 * E * 9 * (n1 + n2) * 128)
    # K3: the planes, six per-pixel arrays per level, the f32 taps; per tap
    # the four validity-folded weights (6 operations) and the bilinear (6)
    b3 = cm.bound_ms(cm.nbytes(p1, p2, *sel) +
                     sum(cm.nbytes(*a[1:7]) for a in sargs),
                     2 * E * 441 * 12)
    print(f'  time (median of 20): K2 {k2_ms!r} ms, plain {p2_ms!r} ms, '
          f'bound {b2[0]!r} ms ({b2[1]}); K3 (both levels) {k3_ms!r} ms, '
          f'plain {p3_ms!r} ms, bound {b3[0]!r} ms ({b3[1]})', flush=True)
    return (err2, k2_ms, p2_ms, b2), (err3, k3_ms, p3_ms, b3)


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


def reset_launches():
    from dpvo_torch.ops import corr_fused, corr_onepass
    corr_onepass.launches = 0
    corr_fused.plane_launches = 0
    corr_fused.select_launches = 0


def read_launches():
    from dpvo_torch.ops import corr_fused, corr_onepass
    return dict(corr_onepass=corr_onepass.launches,
                corr_planes=corr_fused.plane_launches,
                corr_select=corr_fused.select_launches)


def make_slam(cfg, H, W, dev, corr_impl):
    """dpvo_torch.runtime.DPVO with DPVO_CORR_IMPL=corr_impl (read when the
    runtime is built), the motion probe forced (random / untrained weights
    never pass it)."""
    from dpvo_torch.runtime import DPVO, HybridVO
    old = os.environ.get('DPVO_CORR_IMPL')
    os.environ['DPVO_CORR_IMPL'] = corr_impl
    try:
        slam = DPVO(cfg, WEIGHTS, ht=H, wd=W, seed=0, device=dev)
    finally:
        if old is None:
            del os.environ['DPVO_CORR_IMPL']
        else:
            os.environ['DPVO_CORR_IMPL'] = old
    if isinstance(slam, HybridVO):
        slam.motion_probe = lambda: 100.0
    else:
        slam.force_accept = True
    return slam


def main_path(dev, label, corr_impl, n_frames=40, measure=True, **overrides):
    """DPVO at 640x480 with default.yaml (+ overrides) and the full-width
    VONet: n_frames + terminate(), launch counts set to 0 just before and
    read just after. With measure, frames 10..n-11 give the wall time and
    frames n-10..n-1 a profiler trace. Returns (launches, update
    iterations)."""
    import torch
    from dpvo_torch.config import cfg as base_cfg

    H, W = 480, 640
    cfg = base_cfg.clone()
    cfg.merge_from_file(CONFIG)
    for k, v in overrides.items():
        cfg[k] = v
    frames = synthetic_frames(n_frames, H, W, seed=0)
    intr = np.array([460.0, 460.0, W / 2, H / 2], np.float32)
    slam = make_slam(cfg, H, W, dev, corr_impl)
    print(f'  {label}: {type(slam).__name__}, DPVO_CORR_IMPL={corr_impl}',
          flush=True)

    reset_launches()
    walls = []
    trace_frames = range(n_frames - 10 if measure else n_frames, n_frames)
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
        if prof is not None:
            wall_trace = time.perf_counter() - t_trace
            prof.__exit__(None, None, None)
            path = f'{tmp}/trace.json'
            prof.export_chrome_trace(path)
            busy, by_name, n_ops = device_time(path)
        poses, tstamps = slam.terminate()
        torch.cuda.synchronize()
    launches = read_launches()

    expected = 12 + (n_frames - 8) + 12     # bootstrap + 1/frame + refine
    check(poses.shape == (n_frames, 7), f'poses shape {poses.shape}')
    check(np.isfinite(poses).all(), 'poses not finite')
    check(np.allclose(np.linalg.norm(poses[:, 3:], axis=-1), 1.0, atol=1e-3),
          'quaternions not unit')
    for name, t in slam.st.tensors().items():
        check(t.device.type == 'cuda', f'state.{name} on {t.device}')
    edges = f', live edges {len(slam.ii)}' if hasattr(slam, 'ii') else ''
    print(f'  {n_frames} frames + terminate(): keyframes n = {slam.n}'
          f'{edges}, launches {launches} (update iterations = {expected})')
    if not measure:
        return launches, expected

    # frames 10 .. trace start run without the profiler, whose host-side
    # tracing slows every launch: they give the wall time and frames/s
    steady = walls[10:trace_frames.start]
    wall_ms = 1e3 * float(np.median(steady))
    q25, q75 = (1e3 * float(q) for q in np.percentile(steady, [25, 75]))
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
    return launches, expected


def small_cpu_vs_cuda(dev):
    """The runtimes on CUDA (kernels) and on the CPU (plain versions), f32,
    same frames and seed: the poses must agree, and the CUDA run must have
    launched its correlation kernels. DeviceVO at 64x96 (K1 vs ops/corr.py;
    both compute the same f32 ops with sums in another order, bound 1e-3);
    HybridVO at 256x320, M = 8, 16 frames, with onepass (its default: K1
    over the padded edge table) and with fused_k (L2 16x20, so K2 + K3 vs
    their plain versions; the planes may round to bf16 one step apart where
    the f32 sums differ in their last bits), bound 1e-3 as well. Each
    again in bf16 (MIXED_PRECISION), bound 1e-2: the network and the
    correlation maps in bf16 on both sides, with sums in another order."""
    from dpvo_torch.config import cfg as base_cfg

    gb = dict(CENTROID_SEL_STRAT='GRADIENT_BIAS')
    runs = (('DeviceVO', (64, 96), 'onepass', {}, ('corr_onepass',)),
            ('HybridVO', (256, 320), 'onepass', gb, ('corr_onepass',)),
            ('HybridVO', (256, 320), 'fused_k', gb,
             ('corr_planes', 'corr_select')))
    for (label, (H, W), impl, extra, kernels), (mixed, tol) in \
            itertools.product(runs, ((False, 1e-3), (True, 1e-2))):
        cfg = base_cfg.clone()
        cfg.merge_from_file(CONFIG)
        cfg.PATCHES_PER_FRAME = 8
        cfg.BUFFER_SIZE = 64
        cfg.MIXED_PRECISION = mixed
        for k, v in extra.items():
            cfg[k] = v
        frames = synthetic_frames(16, H, W, seed=1)
        intr = np.array([W * 0.625, W * 0.625, W / 2, H / 2], np.float32)
        out = []
        for d in (dev, 'cpu'):
            slam = make_slam(cfg, H, W, d, impl)
            reset_launches()
            for t, img in enumerate(frames):
                slam(t, img, intr)
            out.append(slam.terminate()[0])
            if d == dev:
                launches = read_launches()
        err = float(np.abs(out[0] - out[1]).max())
        prec = 'bf16' if mixed else 'f32'
        check(np.isfinite(out[0]).all(), f'{label}: poses not finite')
        check(err <= tol, f'{label} {prec}: CUDA vs CPU poses differ by '
              f'{err}')
        check(all(launches[k] > 0 for k in kernels),
              f'{label} {impl} on CUDA: launches {launches}')
        print(f'  {label} {H}x{W} {prec}, 16 frames, {impl}: max |pose CUDA '
              f'- pose CPU| = {err!r} (bound {tol!r}; n = {slam.n}; CUDA '
              f'launches {launches})', flush=True)


def probes():
    """Phase 8: the four probe entry points at their scripts' sizes, the
    launch counts set to 0 just before each and read just after. Each
    main holds every kernel against its plain version (and raises off the
    bound); here each probe kernel must also have launched. Returns the
    kernels' JSON entries, one per probe instantiation."""
    import torch
    from dpvo_torch.ops import corr_probes
    from dpvo_torch.scripts import (micro_corr_floor, micro_fused_v2,
                                    micro_kernel_variants, micro_onepass_dma)
    entries = []
    for mod in (micro_fused_v2, micro_corr_floor, micro_onepass_dma,
                micro_kernel_variants):
        corr_probes.reset_launches()
        res = mod.main(device='cuda', scale=1.0, seed=0)
        counts = dict(corr_probes.launches)
        for row in res['variants'].values():
            k = row['kernel']
            check(counts[k] > 0, f'{row["name"]}: kernel never launched')
            check(row['ms'] is not None, f'{row["name"]}: not timed')
            entries.append(dict(
                name=f'probe_{k}', route='cuda',
                source='dpvo_torch/csrc/corr_probes.cu',
                replaces=row['replaces'], launches=counts[k],
                max_abs_err=row['max_abs_err'], ms=row['ms'],
                plain_ms=row['plain_ms'], bound_ms=row['bound_ms'],
                bound_by=row['bound_by'], library_ms=row['library_ms']))
        del res
        torch.cuda.empty_cache()
    names = {e['name'] for e in entries}
    check(len(names) == len(corr_probes.launches),
          f'probe instantiations run: {sorted(names)}')
    return entries


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    name = torch.cuda.get_device_name(0)

    print('[1/8] environment', flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'  torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} device(s): {name}')

    print('[2/8] build', flush=True)
    from concurrent.futures import ThreadPoolExecutor
    from dpvo_torch.ops import corr_fused, corr_onepass, corr_probes
    t0 = time.perf_counter()
    builds = (corr_onepass.build, corr_fused.build, corr_probes.build)
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source
        sos = [f.result() for f in [ex.submit(b) for b in builds]]
    print(f'  {", ".join(so.name for so in sos)} in '
          f'{time.perf_counter() - t0:.1f} s')
    for so in sos:
        for line in so.with_suffix('.log').read_text().splitlines():
            if 'Compiling entry' in line or 'registers' in line \
                    or 'spill' in line:
                print('  ' + line.strip())
    for maps in (torch.bfloat16, torch.float32):
        thr, smem, blocks = corr_onepass.occupancy(maps, torch.bfloat16)
        print(f'  K1 with {maps} maps: {thr} threads and {smem} B of shared '
              f'memory per block, {blocks} blocks per SM')
    for key in ('dots', 'dots2'):
        sh = corr_probes.dots_shape(key, 49152)
        print(f'  K6 {key} at E = 49,152: grid {sh["grid"]}, '
              f'{sh["threads"]} threads, {sh["smem"]} B of dynamic shared '
              f'memory, {sh["regs"]} registers, {sh["resident"]} blocks per '
              f'SM; ring of {sh["stages"]} stages x {sh["rows"]} rows, '
              f'{sh["warps"]} consumer warps')

    print('[3/8] kernels vs plain', flush=True)
    err, k_ms, p_ms, b1 = kernel_vs_plain(dev, E=49152, F=36, H1=120,
                                          W1=160, Ng=36 * 96, nv=40013,
                                          seed=0, timed=True)
    M, G = 48, 320                  # fast.yaml: M = 48, 320 pair slots
    kk = (np.repeat(np.arange(G) % 36, M) * M + np.tile(np.arange(M), G))
    err48, *_ = kernel_vs_plain(dev, E=M * G, F=36, H1=120, W1=160,
                                  Ng=36 * M, nv=300 * M, seed=1, kk=kk)
    k2, k3 = fused_vs_plain(dev, E=49152, F=36, H1=120, W1=160, Ng=36 * 96,
                            seed=2)

    print('[4/8] DeviceVO main path', flush=True)
    dv, dv_iters = main_path(dev, 'default.yaml', 'onepass')
    check(dv['corr_onepass'] >= dv_iters, f'K1 launched '
          f'{dv["corr_onepass"]} times, expected >= {dv_iters}')

    print('[5/8] hybrid main path', flush=True)
    hy, hy_iters = main_path(dev, 'default.yaml + GRADIENT_BIAS', 'fused_k',
                             CENTROID_SEL_STRAT='GRADIENT_BIAS')
    # one K2 launch per update iteration, one K3 launch per level
    check(hy['corr_planes'] >= hy_iters, f'K2 launched '
          f'{hy["corr_planes"]} times, expected >= {hy_iters}')
    check(hy['corr_select'] >= 2 * hy_iters, f'K3 launched '
          f'{hy["corr_select"]} times, expected >= {2 * hy_iters}')

    print('[6/8] DeviceVO with fused_k', flush=True)
    dk, dk_iters = main_path(dev, 'default.yaml', 'fused_k', n_frames=12,
                             measure=False)
    check(dk['corr_planes'] >= dk_iters and
          dk['corr_select'] >= 2 * dk_iters,
          f'K2 / K3 launched {dk}, expected >= {dk_iters} / '
          f'{2 * dk_iters}')

    print('[7/8] CUDA vs CPU', flush=True)
    small_cpu_vs_cuda(dev)

    print('[8/8] correlation probes', flush=True)
    probe_entries = probes()

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound):
        return dict(name=name, route='cuda', source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=None)

    print(smi)
    print(json.dumps({'kernels': [
        entry('corr_onepass', 'dpvo_torch/csrc/corr_onepass.cu',
              'dpvo_tpu/ops/corr_onepass.py:196', dv['corr_onepass'],
              max(err, err48), k_ms, p_ms, b1),
        entry('corr_planes', 'dpvo_torch/csrc/corr_fused.cu',
              'dpvo_tpu/ops/corr_fused.py:94', hy['corr_planes'], *k2),
        entry('corr_select', 'dpvo_torch/csrc/corr_fused.cu',
              'dpvo_tpu/ops/corr_select.py:63', hy['corr_select'], *k3),
        *probe_entries]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
