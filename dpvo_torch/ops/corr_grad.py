"""Two-level correlation with a gradient: the training correlation.

`corr_two_level_train(gmap, fmap1, fmap2, coords, kk, jj)` computes what
ops/corr_onepass.py:corr_two_level computes with f32 output (K1 on the
card, ops/corr.py on the CPU) and differentiates it with respect to gmap,
fmap1 and fmap2. Nothing gathered is saved for the backward: it recomputes
each tap from the maps, so autograd keeps only the maps and the coords,
which the training step holds anyway. At the reference training size the
gathered windows of ops/corr.py would come to ~105 GB per train step.

The backward is `corr_backward`: on the card the hand-written kernel
csrc/corr_backward.cu, which has no TPU counterpart (dpvo_tpu takes this
gradient by XLA autodiff of ops/corr.py:corr, train/trainer.py:220); on the
CPU `corr_backward_plain`, the same function in plain PyTorch. No gradient
flows to the coords: the reference kernel's backward returns none
(altcorr/correlation.py:26-30), which is why dpvo_tpu detaches them.

Tap origins are K1's (ops/corr_onepass.py:_level_boxes): floor(coords) - 3
clamped to +-(dim + 16), NaN sent to -16, so a NaN or far-off coordinate
touches no tap and gets no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from . import corr_onepass, cuda_lib
from .corr_onepass import C, D, P, RADIUS

d = 2 * RADIUS + 1     # outputs per axis
# edges per chunk of the plain backward: its transient windows are chunk x
# 9 x 64 x C f32 (~300 MB at 1024 edges)
_CHUNK = 1024

# kernel launches made by corr_backward (a plain count; callers reset it)
backward_launches = 0

_lib = None


def build():
    """Compile (once per source hash) and load csrc/corr_backward.cu; later
    calls return at once. Returns the path of the shared library."""
    global _lib
    lib, so = cuda_lib.load('corr_backward')
    if _lib is None:
        fn = lib.corr_backward_launch
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return so


def _level_backward(gmap, fmap, c, kk, jj, go, dg, df):
    """Accumulates one level's gradient of n edges into dg (Ng, 9, C) and
    df (F * H * W, C), both f32. c (n, 3, 3, 2) coords at this level's
    scale; go (n, 7, 7, 3, 3) f32, the output gradient [dx, dy, py, px]."""
    n = c.shape[0]
    _, H, W, _ = fmap.shape
    x0, y0 = corr_onepass._level_boxes(c, H, W)[:2]            # (n, 9)
    fx = (c[..., 0] - torch.floor(c[..., 0])).reshape(n, P * P, 1, 1)
    fy = (c[..., 1] - torch.floor(c[..., 1])).reshape(n, P * P, 1, 1)
    g = go.permute(0, 3, 4, 2, 1).reshape(n, P * P, d, d)     # [dy, dx]
    # the 7x7 output gradient spread bilinearly onto the 8x8 integer taps
    dc = g.new_zeros(n, P * P, D, D)
    dc[..., :d, :d] += (1 - fx) * (1 - fy) * g
    dc[..., :d, 1:] += fx * (1 - fy) * g
    dc[..., 1:, :d] += (1 - fx) * fy * g
    dc[..., 1:, 1:] += fx * fy * g
    ar = torch.arange(D, device=c.device)
    yi = y0[..., None] + ar                                   # (n, 9, D)
    xj = x0[..., None] + ar
    valid = ((yi[..., :, None] >= 0) & (yi[..., :, None] < H) &
             (xj[..., None, :] >= 0) & (xj[..., None, :] < W))
    # where, not a product: a NaN coordinate's weights are NaN
    dc = torch.where(valid, dc, 0.0).reshape(n, P * P, D * D)
    rows = ((jj.long()[:, None, None, None] * H +
             yi.clamp(0, H - 1)[..., :, None]) * W +
            xj.clamp(0, W - 1)[..., None, :]).reshape(-1)
    win = fmap.reshape(-1, C).index_select(0, rows).float()
    dg.index_add_(0, kk.long(), torch.einsum(
        'npt,nptc->npc', dc, win.reshape(n, P * P, D * D, C)))
    grow = gmap.reshape(-1, P * P, C).index_select(0, kk.long()).float()
    df.index_add_(0, rows, (dc[..., None] * grow[:, :, None, :])
                  .reshape(-1, C))


def corr_backward_plain(gmap, fmap1, fmap2, coords, kk, jj, grad_out):
    """The gradient of corr_two_level's f32 output with respect to gmap,
    fmap1 and fmap2, in plain PyTorch: per level the output gradient is
    spread bilinearly onto each pixel's 8x8 integer taps, zeroed where a
    tap lies outside the map, then summed with index_add_ into dgmap[kk]
    and dfmap[jj, y, x]. grad_out (E, 7, 7, 3, 3, 2) [dx, dy, py, px,
    lvl]. Returns (dgmap, dfmap1, dfmap2), f32, in the inputs' shapes."""
    dg = torch.zeros((gmap.shape[0], P * P, C), dtype=torch.float32,
                     device=gmap.device)
    dfs = [torch.zeros((f.numel() // C, C), dtype=torch.float32,
                       device=f.device) for f in (fmap1, fmap2)]
    E = coords.shape[0]
    for s in range(0, E, _CHUNK):
        sl = slice(s, s + _CHUNK)
        co = coords[sl].float()
        for lvl, (fmap, c) in enumerate(((fmap1, co), (fmap2, co / 4.0))):
            _level_backward(gmap, fmap, c, kk[sl], jj[sl],
                            grad_out[sl, ..., lvl].float(), dg, dfs[lvl])
    return (dg.reshape(gmap.shape), dfs[0].reshape(fmap1.shape),
            dfs[1].reshape(fmap2.shape))


def corr_backward(gmap, fmap1, fmap2, coords, kk, jj, grad_out):
    """corr_backward_plain's function, on the card through the kernel.

    Inputs as corr_onepass.corr_two_level takes them (gmap, fmap1, fmap2
    channels-last, one dtype, bf16 or f32; coords f32; kk / jj int32 on
    the card) and grad_out (E, 7, 7, 3, 3, 2) f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise. Returns
    (dgmap, dfmap1, dfmap2) in the maps' dtype: summed in f32 (atomics, in
    an order that changes from run to run) and rounded once."""
    global backward_launches
    if coords.device.type == 'cpu':
        grads = corr_backward_plain(gmap, fmap1, fmap2, coords, kk, jj,
                                    grad_out)
        return tuple(g.to(m.dtype) for g, m in
                     zip(grads, (gmap, fmap1, fmap2)))
    corr_onepass.check_inputs(gmap, fmap1, fmap2, coords, kk, jj)
    E = coords.shape[0]
    if (grad_out.shape != (E, d, d, P, P, 2) or
            grad_out.dtype != torch.float32 or
            grad_out.device != coords.device):
        raise ValueError(f'grad_out must be ({E}, {d}, {d}, {P}, {P}, 2) '
                         f'f32 on {coords.device}, got '
                         f'{tuple(grad_out.shape)} {grad_out.dtype} on '
                         f'{grad_out.device}')
    coords, kk, jj = coords.contiguous(), kk.contiguous(), jj.contiguous()
    grad_out = grad_out.contiguous()
    grads = [torch.zeros(m.shape, dtype=torch.float32, device=m.device)
             for m in (gmap, fmap1, fmap2)]
    if E:
        if _lib is None:
            build()
        err = _lib.corr_backward_launch(
            gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
            coords.data_ptr(), kk.data_ptr(), jj.data_ptr(),
            grad_out.data_ptr(), *(g.data_ptr() for g in grads), E,
            gmap.shape[0], fmap1.shape[0], fmap1.shape[1], fmap1.shape[2],
            fmap2.shape[1], fmap2.shape[2],
            int(gmap.dtype == torch.bfloat16), coords.device.index,
            torch.cuda.current_stream(coords.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f'corr_backward kernel launch failed: CUDA '
                               f'error {err}')
        backward_launches += 1
    return tuple(g.to(m.dtype) for g, m in zip(grads, (gmap, fmap1, fmap2)))


class _CorrTwoLevelTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gmap, fmap1, fmap2, coords, kk, jj):
        ctx.save_for_backward(gmap, fmap1, fmap2, coords, kk, jj)
        return corr_onepass.corr_two_level(gmap, fmap1, fmap2, coords, kk,
                                           jj, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        gmap, fmap1, fmap2, coords, kk, jj = ctx.saved_tensors
        dg, d1, d2 = corr_backward(gmap, fmap1, fmap2, coords, kk, jj,
                                   grad.float())
        return dg, d1, d2, None, None, None


def corr_two_level_train(gmap, fmap1, fmap2, coords, kk, jj):
    """corr_onepass.corr_two_level (f32 out, all edges) with a gradient for
    gmap, fmap1 and fmap2 (none for coords, kk, jj): (E, 7, 7, 3, 3, 2)
    [dx, dy, py, px, lvl]."""
    return _CorrTwoLevelTrain.apply(gmap, fmap1, fmap2, coords, kk, jj)
