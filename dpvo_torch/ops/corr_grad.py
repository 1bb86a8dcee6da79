"""Two-level correlation with a gradient: the training correlation.

`corr_two_level_train(gmap, fmap1, fmap2, coords, kk, jj)` computes what
ops/corr_onepass.py:corr_two_level computes with f32 output (K1 on the
card, ops/corr.py on the CPU) and differentiates it with respect to gmap,
fmap1 and fmap2. Nothing gathered is saved for the backward: it recomputes
each tap from the maps, so autograd keeps only the maps and the coords,
which the training step holds anyway. At the reference training size the
gathered windows of ops/corr.py would come to ~105 GB per train step.

The backward is `corr_backward`: on the card the hand-written kernels of
csrc/corr_backward.cu, which have no TPU counterpart (dpvo_tpu takes this
gradient by XLA autodiff of ops/corr.py:corr, train/trainer.py:220); on the
CPU `corr_backward_plain`, the same function in plain PyTorch. The card's
design bins the edges by target tile on the device and sums each tile's map
gradient in shared memory, one block per tile, so dfmap1 and dfmap2 are
written once, with no atomics, and are bit-identical from run to run;
`backward_work` reads back what the binning made of a call. No gradient
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

# the tiles' (rows, columns) of map positions at level 1 and level 2, by
# the maps' dtype: one block per tile (csrc/corr_backward.cu:bw_tiles),
# two blocks per SM (scripts/ring_sweep.py --backward sweeps them)
TILES = {torch.bfloat16: ((12, 8), (8, 8)), torch.float32: ((8, 8), (8, 8))}

_lib = None


def build():
    """Compile (once per source hash) and load csrc/corr_backward.cu; later
    calls return at once. Returns the path of the shared library."""
    global _lib
    lib, so = cuda_lib.load('corr_backward')
    if _lib is None:
        P_, I_ = ctypes.c_void_p, ctypes.c_int
        cuda_lib.bind(lib, {
            'corr_backward_launch': [P_] * 11 + [I_] * 13 + [P_],
            'corr_backward_plan': [I_] * 11 + [ctypes.POINTER(
                ctypes.c_longlong)],
            'corr_backward_occupancy': [I_] * 6 + [ctypes.POINTER(I_)] * 3,
        })
        _lib = lib
    return so


def _tiles(dtype, tiles):
    """[th1, tw1, th2, tw2] of `tiles`, or of TILES[dtype] when None."""
    t = TILES[dtype] if tiles is None else tiles
    return [int(v) for lv in t for v in lv]


def plan(E, F, H1, W1, H2, W2, dtype=torch.bfloat16, tiles=None):
    """The kernel's scratch and tiles for a call (tiles as TILES gives
    them): {'bytes', 'tiles' (level 1, level 2), 'stats_at', 'rec_at'
    (byte offsets in the scratch), 'smem' (the tile kernel's shared
    bytes)}. Raises for tiles that do not fit a block's shared memory."""
    if _lib is None:
        build()
    out = (ctypes.c_longlong * 6)()
    err = _lib.corr_backward_plan(E, F, H1, W1, H2, W2,
                                  *_tiles(dtype, tiles),
                                  int(dtype == torch.bfloat16), out)
    if err != 0:
        raise ValueError(f'corr_backward: tiles {tiles or TILES[dtype]} do '
                         f'not fit a block ({dtype} maps)')
    return dict(bytes=out[0], tiles=(out[1], out[2]), stats_at=out[3],
                rec_at=out[4], smem=out[5])


def occupancy(dtype=torch.bfloat16, tiles=None, device=0):
    """(threads, shared bytes, blocks per SM) of the tile kernel for these
    maps and tiles, as the CUDA runtime reports it on `device`."""
    if _lib is None:
        build()
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib.corr_backward_occupancy(
        *_tiles(dtype, tiles), int(dtype == torch.bfloat16), device,
        *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f'corr_backward_occupancy: CUDA error {err}')
    return tuple(v.value for v in vals)


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


def _launch(gmap, fmap1, fmap2, coords, kk, jj, grad_out, tiles=None):
    """The kernels on CUDA inputs: (dgmap, dfmap1, dfmap2 in the maps'
    dtype, the scratch, the plan)."""
    global backward_launches
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
    dev = coords.device
    F, H1, W1 = fmap1.shape[:3]
    H2, W2 = fmap2.shape[1:3]
    dg = torch.zeros(gmap.shape, dtype=torch.float32, device=dev)
    if E == 0:
        return (dg.to(gmap.dtype), torch.zeros_like(fmap1),
                torch.zeros_like(fmap2), None, None)
    pl = plan(E, F, H1, W1, H2, W2, gmap.dtype, tiles)
    # written whole by the tile kernel: no fill
    d1, d2 = torch.empty_like(fmap1), torch.empty_like(fmap2)
    scratch = torch.empty(pl['bytes'], dtype=torch.uint8, device=dev)
    err = _lib.corr_backward_launch(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        coords.data_ptr(), kk.data_ptr(), jj.data_ptr(), grad_out.data_ptr(),
        dg.data_ptr(), d1.data_ptr(), d2.data_ptr(), scratch.data_ptr(), E,
        gmap.shape[0], F, H1, W1, H2, W2, *_tiles(gmap.dtype, tiles),
        int(gmap.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'corr_backward kernel launch failed: CUDA error '
                           f'{err}')
    backward_launches += 1
    return dg.to(gmap.dtype), d1, d2, scratch, pl


def corr_backward(gmap, fmap1, fmap2, coords, kk, jj, grad_out):
    """corr_backward_plain's function, on the card through the kernels.

    Inputs as corr_onepass.corr_two_level takes them (gmap, fmap1, fmap2
    channels-last, one dtype, bf16 or f32; coords f32; kk / jj int32 on
    the card) and grad_out (E, 7, 7, 3, 3, 2) f32. CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise. Returns
    (dgmap, dfmap1, dfmap2) in the maps' dtype, each summed in f32 and
    rounded once: dfmap1 and dfmap2 in shared memory, in an order fixed by
    the inputs (bit-identical from run to run); dgmap with atomics, in an
    order that changes."""
    if coords.device.type == 'cpu':
        grads = corr_backward_plain(gmap, fmap1, fmap2, coords, kk, jj,
                                    grad_out)
        return tuple(g.to(m.dtype) for g, m in
                     zip(grads, (gmap, fmap1, fmap2)))
    return _launch(gmap, fmap1, fmap2, coords, kk, jj, grad_out)[:3]


def backward_work(gmap, fmap1, fmap2, coords, kk, jj, grad_out, tiles=None):
    """One corr_backward launch on CUDA inputs (counted), and what its
    binning made: {'grads': the three gradients, 'tiles' (level 1, level
    2), 'stats' ((tiles, 4) int64 per tile, level-2 tiles first, each
    level's in (frame, tile row, tile column) order: box entries, pixel
    entries, pixels with a dgmap atomic, batches), 'masks' ((2, E) int64
    per level and edge: bits 0-8 the pixels summed with the edge's box,
    9-17 those summed on their own), 'plan'}."""
    dg, d1, d2, scratch, pl = _launch(gmap, fmap1, fmap2, coords, kk, jj,
                                      grad_out, tiles)
    E = coords.shape[0]
    nt = sum(pl['tiles'])
    stats = scratch[pl['stats_at']:pl['stats_at'] + 16 * nt].view(
        torch.int32).reshape(nt, 4).long().cpu()
    rec = scratch[pl['rec_at']:pl['rec_at'] + 2 * E * 128].view(
        torch.int32).reshape(2, E, 32)
    return dict(grads=(dg, d1, d2), tiles=pl['tiles'], stats=stats,
                masks=rec[..., 2].long().cpu(), plan=pl)


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
