"""What the probe scripts share: the device, seeded inputs, CUDA-event
timing, the roofline bound, and one checked, timed row per variant."""
from __future__ import annotations

import argparse

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
C = 128


def device(name):
    """torch.device(name); a CUDA device must exist (no fallback)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the probes run on the card '
                           "(pass device='cpu' for the plain versions)")
    return dev


def scaled(n, scale, multiple):
    """n * scale rounded to a multiple of `multiple` (at least one)."""
    return max(multiple, int(round(n * scale / multiple)) * multiple)


def normal(rng, shape, dev, dtype=torch.bfloat16):
    """N(0, 1) of `shape` from the numpy Generator rng, drawn in f32 in
    chunks along dim 0 and stored as `dtype` on dev."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    per = int(np.prod(shape[1:]))
    step = max(1, 2 ** 26 // max(per, 1))
    for s in range(0, shape[0], step):
        n = min(step, shape[0] - s)
        a = rng.standard_normal((n, *shape[1:]), dtype=np.float32)
        out[s:s + n] = torch.from_numpy(a).to(dev).to(dtype)
    return out


def ints(a, dev):
    """A numpy integer array as a contiguous int32 tensor on dev."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def window_yx(by, bx, wx, npos):
    """(y, x) of the first npos positions of windows wx wide at (by, bx):
    position q is row q // wx, column q % wx. (E, npos) int64 each."""
    q = torch.arange(npos, device=by.device)
    return by.long()[:, None] + q // wx, bx.long()[:, None] + q % wx


def map_bytes(jj, y, x, F, H, W):
    """Bytes of the distinct in-map pixels of (F, H, W, 128) bf16 maps
    that positions (y, x) of frames jj touch: what a kernel must read of
    the maps. jj (E,) or None (one map); y, x broadcastable, leading E."""
    y, x = torch.broadcast_tensors(y.long(), x.long())
    j = torch.zeros_like(y) if jj is None else \
        jj.long().reshape(-1, *([1] * (y.dim() - 1))).expand_as(y)
    ok = (y >= 0) & (y < H) & (x >= 0) & (x < W) & (j >= 0) & (j < F)
    mask = torch.zeros(F * H * W, dtype=torch.bool, device=y.device)
    mask[((j * H + y) * W + x)[ok]] = True
    return int(mask.sum()) * C * 2


def bound_ms(nbytes_, flops):
    """The least time the card could take: the larger of the bytes over
    HBM bandwidth and the operations over the bf16 tensor-core peak.
    Returns (ms, 'bytes' | 'operations')."""
    tb = nbytes_ / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOP_PER_S * 1e3
    return (tb, 'bytes') if tb >= tf else (tf, 'operations')


def time_ms(fn, reps=20):
    """Median time of fn() over `reps` runs, each alone between two CUDA
    events after a synchronize (so it includes the host's work before the
    launch), after one warm-up run."""
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


def _batch_ms(fn, reps):
    """Device ms per run of `reps` runs of fn() back to back between two
    CUDA events: each run's host work (checks, allocation, launch)
    overlaps the run before it, so the time is the device's."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, rounds=5, reps=20):
    """fn's device time: `rounds` rounds of `reps` runs back to back
    (_batch_ms), after one warm-up run. Returns (the rounds' median ms per
    run, the rounds' ms)."""
    fn()
    torch.cuda.synchronize()
    times = [_batch_ms(fn, reps) for _ in range(rounds)]
    return float(np.median(times)), times


def time_paired(fn, other, rounds=5, reps=20):
    """fn() and other() timed in turns, after one warm-up run of each:
    `rounds` rounds of (fn x reps, other x reps), each batch back to back
    (_batch_ms), so that clock and power drift hit both alike. Returns
    (median over the rounds of fn's ms per run, the same of other's, the
    rounds' ratios)."""
    fn()
    other()
    torch.cuda.synchronize()
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(_batch_ms(fn, reps))
        tb.append(_batch_ms(other, reps))
    ratios = [a / b for a, b in zip(ta, tb)]
    return float(np.median(ta)), float(np.median(tb)), ratios


def paired(a, b):
    """Two calls timed in turns (time_paired: device time of back-to-back
    launches), each given as (name, fn, bytes its kernel copies from L2 to
    the SMs or None); the bytes give its rate. Prints one line; returns
    {'ms', 'other_ms', 'ratio' (a / b), 'ratios' (the rounds'),
    'tb_per_s', 'other_tb_per_s'}."""
    (name, fn, copied), (other_name, other, other_copied) = a, b
    ms, other_ms, ratios = time_paired(fn, other)
    rates = [None if c is None else c / t / 1e9
             for c, t in ((copied, ms), (other_copied, other_ms))]
    row = dict(ms=ms, other_ms=other_ms, ratio=ms / other_ms, ratios=ratios,
               tb_per_s=rates[0], other_tb_per_s=rates[1])
    tail = ''.join(f'; {n} copies {c / 1e9!r} GB from L2, {r!r} TB/s'
                   for n, c, r in ((name, copied, rates[0]),
                                   (other_name, other_copied, rates[1]))
                   if c is not None)
    print(f'  in turns (device time): {name} {ms!r} ms, {other_name} '
          f'{other_ms!r} ms, ratio {row["ratio"]!r} (rounds '
          f'{min(ratios)!r} .. {max(ratios)!r}){tail}', flush=True)
    return row


def compare(got, ref):
    """max |got - ref| and max |ref| over the outputs, and whether every
    entry is within its bound: bf16 outputs one bf16 rounding apart,
    |d| <= 2^-7 |ref| + 1e-5 max|ref| (both sum the same f32 products in
    another order, then round); f32 outputs <= 1e-5 max|ref| (the sum order
    only)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    ref = ref if isinstance(ref, (tuple, list)) else (ref,)
    err, scale, ok = 0.0, 0.0, True
    for a, b in zip(got, ref, strict=True):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise RuntimeError(f'kernel output {tuple(a.shape)} {a.dtype} vs '
                               f'plain {tuple(b.shape)} {b.dtype}')
        m = b.float().abs().max().item() if b.numel() else 0.0
        d = (a.float() - b.float()).abs()
        if b.dtype == torch.bfloat16:
            bound = 2 ** -7 * b.float().abs() + 1e-5 * m
        else:
            bound = torch.full_like(d, 1e-5 * m)
        ok = ok and bool(torch.isfinite(a).all()) and bool((d <= bound).all())
        err = max(err, d.max().item() if d.numel() else 0.0)
        scale = max(scale, m)
    return err, scale, ok


def run(name, kernel, replaces, fn, plain, nbytes_, flops, dev,
        library=None, library_form=None):
    """One variant: fn() (the wrapper) against plain() on the same inputs
    (raises if any entry is off its bound), then, on the card, the median
    times (time_ms) of both and of `library` (one PyTorch call computing
    the same function, used nowhere in the port), and the roofline bound of
    this run's bytes and operations. Where `library` is given, fn and
    library are also timed in turns (time_paired: device time of
    back-to-back runs): `ms_paired`, `library_ms_paired`, their `ratio` and
    the rounds' `ratios`. Prints one line; returns its dict."""
    got, ref = fn(), plain()
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    err, scale, ok = compare(got, ref)
    if not ok:
        raise RuntimeError(f'{name}: kernel vs plain off the bound (max '
                           f'|diff| {err} at max|plain| {scale})')
    b_ms, b_by = bound_ms(nbytes_, flops)
    row = dict(name=name, kernel=kernel, replaces=replaces, max_abs_err=err,
               max_abs_plain=scale, bytes=nbytes_, flops=flops, bound_ms=b_ms,
               bound_by=b_by, ms=None, plain_ms=None, library_ms=None,
               library=library_form, ms_paired=None, library_ms_paired=None,
               ratio=None, ratios=None)
    if dev.type == 'cuda':
        row['ms'] = time_ms(fn)
        row['plain_ms'] = time_ms(plain)
        if library is not None:
            row['library_ms'] = time_ms(library)
            row['ms_paired'], row['library_ms_paired'], row['ratios'] = \
                time_paired(fn, library)
            row['ratio'] = row['ms_paired'] / row['library_ms_paired']
    lib = ''
    if library is not None:
        lib = f', library {row["library_ms"]!r} ms ({library_form})'
        if row['ratio'] is not None:
            lib += (f'; in turns {row["ms_paired"]!r} ms against '
                    f'{row["library_ms_paired"]!r}, kernel / library '
                    f'{row["ratio"]!r} (rounds {min(row["ratios"])!r} .. '
                    f'{max(row["ratios"])!r})')
    print(f'  {name}: {row["ms"]!r} ms, plain {row["plain_ms"]!r} ms, bound '
          f'{b_ms!r} ms ({b_by}: {nbytes_ / 1e6:.1f} MB, {flops / 1e9:.2f} '
          f'GFLOP){lib}; max|kernel - plain| {err!r} at max|plain| '
          f'{scale!r}', flush=True)
    return row


def cli(main, doc):
    """`python -m dpvo_torch.scripts.<probe> [--device --scale --seed]`."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--scale', type=float, default=1.0)
    ap.add_argument('--seed', type=int, default=0)
    a = ap.parse_args()
    main(device=a.device, scale=a.scale, seed=a.seed)
