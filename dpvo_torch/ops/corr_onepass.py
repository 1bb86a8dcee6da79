"""Two-level correlation through the hand-written Hopper kernel.

`corr_two_level` is the wrapper of csrc/corr_onepass.cu, the port of the
TPU kernel dpvo_tpu/ops/corr_onepass.py:_onepass_kernel. For tensors on the
CPU it runs the plain PyTorch version (ops/corr.py:corr_two_level); for
CUDA tensors it launches the kernel or raises. The kernel is compiled with
nvcc from the source in this checkout on first use (ops/cuda_lib.py) and
bound with ctypes: pointers from data_ptr(), the stream from PyTorch's
current stream.
"""
from __future__ import annotations

import ctypes

import torch

from . import corr as _plain
from . import cuda_lib

RADIUS = 3
P = 3
C = 128

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
        _lib = lib
    return so


def _check_map(name, t, dev):
    if t.device != dev:
        raise ValueError(f'{name} is on {t.device}, coords on {dev}')
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f'{name} must be bf16 or f32, got {t.dtype}')
    if t.dim() != 4 or t.shape[-1] != C:
        raise ValueError(f'{name} must be (N, H, W, {C}), got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


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
        return _plain.corr_two_level(gmap, fmap1, fmap2, coords, kk, jj,
                                     nv=nv, out_dtype=out_dtype)
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
