"""Two-level correlation through the hand-written Hopper kernel.

`corr_two_level` is the wrapper of csrc/corr_onepass.cu, the port of the
TPU kernel dpvo_tpu/ops/corr_onepass.py:_onepass_kernel. For tensors on the
CPU it runs the plain PyTorch version (ops/corr.py:corr_two_level); for
CUDA tensors it launches the kernel or raises. The kernel is compiled with
nvcc from the source in this checkout on first use (ops/cuda_lib.py) and
bound with ctypes: pointers from data_ptr(), the stream from PyTorch's
current stream.

With bf16 maps the kernel stages each edge's union box per level in shared
memory and takes a pixel whose window does not fit it from global memory;
`box_fits` states that rule in plain PyTorch, so tests can see which branch
each pixel takes (both compute the same output).
"""
from __future__ import annotations

import ctypes

import torch

from .corr import corr_two_level as _plain_two_level
from . import cuda_lib

RADIUS = 3
P = 3
C = 128
D = 2 * RADIUS + 2     # integer taps per axis of a window
BOX = 12               # the union box's side cap, both levels (kBox)

# kernel launches made by corr_two_level (a plain count; callers reset it)
launches = 0

_lib = None


def build():
    """Compile (once per source hash) and load csrc/corr_onepass.cu; later
    calls return at once. Returns the path of the shared library (the
    ptxas log sits beside it as a .log file)."""
    global _lib
    lib, so = cuda_lib.load('corr_onepass')
    if _lib is None:
        fn = lib.corr_onepass_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.corr_onepass_occupancy
        occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
        occ.restype = ctypes.c_int
        _lib = lib
    return so


def occupancy(in_dtype, out_dtype, device=0):
    """(threads, shared bytes, blocks per SM) of the kernel that these
    dtypes select, as the CUDA runtime reports it on `device`."""
    if _lib is None:
        build()
    vals = [ctypes.c_int() for _ in range(3)]
    err = _lib.corr_onepass_occupancy(
        int(in_dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        device, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f'corr_onepass_occupancy: CUDA error {err}')
    return tuple(v.value for v in vals)


def _level_boxes(c, H, W):
    """Window origins (x0, y0), each (E, 9) int64, and the union box (bx,
    by, bw, bh), each (E,), of one level: floor(c) - R, clamped to +-(dim +
    16) first (NaN to -16, as the kernel's fmaxf / fminf do); the box spans
    the nine windows, at most BOX rows and columns from (bx, by)."""
    def origin(v, dim):
        f = torch.floor(v.reshape(v.shape[0], P * P))
        f = torch.where(torch.isnan(f), torch.full_like(f, -16.0), f)
        return f.clamp(-16.0, dim + 16.0).long() - RADIUS
    x0, y0 = origin(c[..., 0], W), origin(c[..., 1], H)
    bx, by = x0.min(1).values, y0.min(1).values
    bw = (x0.max(1).values - bx + D).clamp(max=BOX)
    bh = (y0.max(1).values - by + D).clamp(max=BOX)
    return x0, y0, bx, by, bw, bh


def _levels(coords, H1, W1, H2, W2):
    return ((coords, H1, W1), (coords / 4.0, H2, W2))


def box_fits(coords, H1, W1, H2, W2):
    """Which branch the bf16 kernel takes for each pixel: (E, 3, 3, 2) bool
    [py, px, lvl], True where the pixel's 8x8 window lies inside its
    level's union box (taps from shared memory), False where it overflows
    (taps from global memory). coords (E, 3, 3, 2) f32 at level-1 scale;
    (H1, W1), (H2, W2) the two maps' sizes."""
    out = []
    for c, H, W in _levels(coords, H1, W1, H2, W2):
        x0, y0, bx, by, _, _ = _level_boxes(c, H, W)
        out.append((x0 - bx[:, None] <= BOX - D) &
                   (y0 - by[:, None] <= BOX - D))
    return torch.stack(out, -1).reshape(coords.shape[0], P, P, 2)


def box_rows(coords, H1, W1, H2, W2):
    """(E, 2) int64: the rows of 128 channels the bf16 kernel stages per
    edge and level (bw * bh of the union box)."""
    rows = []
    for c, H, W in _levels(coords, H1, W1, H2, W2):
        *_, bw, bh = _level_boxes(c, H, W)
        rows.append(bw * bh)
    return torch.stack(rows, -1)


def _check_map(name, t, dev):
    if t.device != dev:
        raise ValueError(f'{name} is on {t.device}, coords on {dev}')
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name} must be bf16 or f32, got {t.dtype}')
    if t.dim() != 4 or t.shape[-1] != C:
        raise ValueError(f'{name} must be (N, H, W, {C}), got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def check_inputs(gmap, fmap1, fmap2, coords, kk, jj):
    """Raises unless the kernels' inputs are on a CUDA device, of the
    layout and dtypes corr_two_level states, and contiguous (coords, kk
    and jj are made contiguous by the callers)."""
    dev = coords.device
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    E = coords.shape[0]
    if coords.shape != (E, P, P, 2) or coords.dtype != torch.float32:
        raise ValueError(f'coords must be ({E}, {P}, {P}, 2) f32, got '
                         f'{tuple(coords.shape)} {coords.dtype}')
    if gmap.dim() != 4 or gmap.shape[1:] != (P, P, C):
        raise ValueError(f'gmap must be (Ng, {P}, {P}, {C}), got '
                         f'{tuple(gmap.shape)}')
    for name, t in (('gmap', gmap), ('fmap1', fmap1), ('fmap2', fmap2)):
        _check_map(name, t, dev)
    if not (gmap.dtype == fmap1.dtype == fmap2.dtype):
        raise TypeError('gmap, fmap1 and fmap2 must share one dtype')
    if fmap1.shape[0] != fmap2.shape[0]:
        raise ValueError('fmap1 and fmap2 must hold the same frames')
    for name, t in (('kk', kk), ('jj', jj)):
        if t.device != dev or t.dtype != torch.int32 or t.shape != (E,):
            raise ValueError(f'{name} must be ({E},) int32 on {dev}, got '
                             f'{tuple(t.shape)} {t.dtype} on {t.device}')


def corr_two_level(gmap, fmap1, fmap2, coords, kk, jj, nv=None,
                   out_dtype=torch.float32):
    """Local correlation at both pyramid levels, one launch on the card.

    gmap (Ng, 3, 3, 128); fmap1 (F, H1, W1, 128); fmap2 (F, H2, W2, 128),
    channels-last, bf16 or f32 (one dtype); coords (E, 3, 3, 2) f32 at
    level-1 scale; kk / jj (E,) int32 (int64 accepted on the CPU);
    nv: int or 0-d integer tensor, edges >= nv are exact zeros (None = E).
    Returns (E, 7, 7, 3, 3, 2) in out_dtype, layout [dx, dy, py, px, lvl]
    (see ops/corr.py:corr_two_level)."""
    global launches
    dev = coords.device
    if dev.type == 'cpu':
        return _plain_two_level(gmap, fmap1, fmap2, coords, kk, jj, nv=nv,
                                out_dtype=out_dtype)
    check_inputs(gmap, fmap1, fmap2, coords, kk, jj)
    E = coords.shape[0]
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'out_dtype must be bf16 or f32, got {out_dtype}')
    coords, kk, jj = coords.contiguous(), kk.contiguous(), jj.contiguous()
    if nv is None:
        nv = E
    if isinstance(nv, torch.Tensor):
        nv_t = nv.to(device=dev, dtype=torch.int32).reshape(1)
    else:
        nv_t = torch.full((1,), int(nv), dtype=torch.int32, device=dev)

    out = torch.empty((E, 2 * RADIUS + 1, 2 * RADIUS + 1, P, P, 2),
                      dtype=out_dtype, device=dev)
    if E == 0:
        return out
    if _lib is None:
        build()
    err = _lib.corr_onepass_launch(
        gmap.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(),
        coords.data_ptr(), kk.data_ptr(), jj.data_ptr(), nv_t.data_ptr(),
        out.data_ptr(), E, gmap.shape[0], fmap1.shape[0],
        fmap1.shape[1], fmap1.shape[2], fmap2.shape[1], fmap2.shape[2],
        int(gmap.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        out.device.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'corr_onepass kernel launch failed: CUDA error '
                           f'{err}')
    launches += 1
    return out
