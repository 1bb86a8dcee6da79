"""The correlation probes K4-K8: wrappers and plain versions.

Ports of the Pallas kernels of the four probe scripts (scripts/micro_*.py),
each a variant of K2's per-edge correlation planes (ops/corr_fused.py): for
edge e, the dot of its 9 source-patch pixels g9[e] with every pixel of a
window of a target map, f32 accumulation. csrc/corr_probes.cu has the
kernels; one wrapper per instantiation:

  planes_pair     K4  scripts/micro_fused_v2.py:_plane_kernel_k2
  planes_roll     K5  scripts/micro_fused_v2.py:_plane_kernel_roll
  dots, dots2     K6  scripts/micro_corr_floor.py:dot_kernel, dot_kernel2
  slab            K6  scripts/micro_corr_floor.py:fused_kernel
  planes_first49  K7  scripts/micro_onepass_dma.py:kernel (STREAMS 0 / 1)
  planes_w12x16   K8  scripts/micro_kernel_variants.py:make_kernel (full,
                      twodots, rank3)
  planes_fixedw   K8  the same, mode fixedw

Inputs are in the port's terms: unpadded channels-last bf16 maps, the
edges' pre-gathered source rows g9 (E, 9, 128), int32 target frames jj and
window bases by, bx in image coordinates; positions outside the map read
as zero (what the TPU's padded slabs held). A TPU phase-shifted copy of a
map is a base of bx + 4 * ph.

For tensors on the CPU the wrappers run the plain versions (`*_plain`);
for CUDA tensors they launch the kernel or raise. `launches` counts the
launches of each instantiation (callers reset it). The library is
compiled from the checkout's source on first use (ops/cuda_lib.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

P2 = 9
C = 128
WY, WX = 12, 24          # K2's level-1 window (K4, K5, K7)
WY2, WX2 = 10, 16        # K2's level-2 window
WV = (12, 16)            # K8's window at both levels
FIRST = 49               # K7 keeps the first 49 columns of each level
DOTS_W = 384             # K6 dot_kernel's window rows
DOTS2_W = 256            # K6 dot_kernel2 reads the first 256 of them
SLAB = 16                # K6 fused_kernel's 16 x 16 window
_CHUNK = 512             # edges per chunk of the plain versions

launches = dict.fromkeys((
    'planes_pair', 'planes_roll', 'dots', 'dots2', 'slab', 'planes_first49',
    'planes_first49_streams', 'planes_w12x16', 'planes_fixedw'), 0)

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def build():
    """Compile (once per source hash) and load csrc/corr_probes.cu. Returns
    the path of the shared library (ptxas log beside it as .log)."""
    global _lib
    lib, so = cuda_lib.load('corr_probes')
    if _lib is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        sigs = {
            'probe_planes_pair_launch': [P] * 10 + [I] * 7 + [P],
            'probe_planes_roll_launch': [P] * 12 + [I] * 7 + [P],
            'probe_planes_first49_launch': ([P] * 14 + [I] * 2 + [P] * 3 +
                                            [I] * 8 + [P]),
            'probe_planes_w12x16_launch': [P] * 10 + [I] * 8 + [P],
            'probe_dots_launch': [P] * 3 + [I] * 4 + [P],
            'probe_dots_shape': [I] * 4 + [P],
            'probe_slab_launch': [P] * 5 + [I] * 4 + [P],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return so


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def window_dots(g9, fmap, jj, by, bx, wx, npos):
    """f32 (E, 9, npos): out[e, p, q] = g9[e, p] . fmap[jj[e], by[e] + q //
    wx, bx[e] + q % wx], 0 outside the map (or for a frame out of range).
    fmap (F, H, W, C); jj None reads frame 0."""
    E = g9.shape[0]
    F, H, W, _ = fmap.shape
    dev = g9.device
    rows = fmap.reshape(-1, C)
    q = torch.arange(npos, device=dev)
    out = torch.empty((E, P2, npos), dtype=torch.float32, device=dev)
    for s in range(0, E, _CHUNK):
        sl = slice(s, s + _CHUNK)
        j = (torch.zeros_like(by[sl]) if jj is None else jj[sl]).long()
        y = by[sl].long()[:, None] + q // wx
        x = bx[sl].long()[:, None] + q % wx
        valid = ((y >= 0) & (y < H) & (x >= 0) & (x < W) &
                 ((j >= 0) & (j < F))[:, None])
        idx = (j.clamp(0, F - 1)[:, None] * H + y.clamp(0, H - 1)) * W + \
            x.clamp(0, W - 1)
        win = rows.index_select(0, idx.reshape(-1)).reshape(-1, npos, C)
        pl = torch.bmm(g9[sl].float(), win.float().transpose(1, 2))
        out[sl] = torch.where(valid[:, None, :], pl, 0.0)
    return out


def planes_pair_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """Plain K4 (= K2's planes): (E, 9, 288) and (E, 9, 160) bf16."""
    return (window_dots(g9, fmap1, jj, by1, bx1, WX, WY * WX).bfloat16(),
            window_dots(g9, fmap2, jj, by2, bx2, WX2, WY2 * WX2).bfloat16())


def _roll(plane, sh):
    """out[e, p, c] = plane[e, p, (c + sh[e]) mod N]."""
    E, _, N = plane.shape
    c = torch.arange(N, device=plane.device)
    idx = torch.remainder(c + sh.long()[:, None], N)
    return torch.gather(plane, 2, idx[:, None, :].expand(E, P2, N))


def planes_roll_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, sh1, sh2):
    """Plain K5: K2's planes, each level of edge e rolled by -sh[e] over the
    flattened plane. (E, 9, 288), (E, 9, 160) bf16."""
    p1, p2 = planes_pair_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    return _roll(p1, sh1), _roll(p2, sh2)


def planes_first49_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """Plain K7: the first 49 columns of each level's flattened f32 plane
    row (K2's windows), (E * 9, 49) f32 per level."""
    E = g9.shape[0]
    return (window_dots(g9, fmap1, jj, by1, bx1, WX, FIRST).reshape(
                E * P2, FIRST),
            window_dots(g9, fmap2, jj, by2, bx2, WX2, FIRST).reshape(
                E * P2, FIRST))


def planes_w12x16_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """Plain K8 (modes full / twodots / rank3): 12 x 16 windows at both
    levels, (E, 9, 192) bf16 each."""
    wy, wx = WV
    return (window_dots(g9, fmap1, jj, by1, bx1, wx, wy * wx).bfloat16(),
            window_dots(g9, fmap2, jj, by2, bx2, wx, wy * wx).bfloat16())


def planes_fixedw_plain(g9, fmap1, fmap2, jj):
    """Plain K8 fixedw: every window at (0, 0) of its frame."""
    z = torch.zeros_like(jj)
    return planes_w12x16_plain(g9, fmap1, fmap2, jj, z, z, z, z)


def dots_plain(g9, win):
    """Plain K6 dot_kernel: (E, 9, W) f32 = g9 @ win^T per edge."""
    out = torch.empty((g9.shape[0], P2, win.shape[1]), dtype=torch.float32,
                      device=g9.device)
    for s in range(0, g9.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        out[sl] = torch.bmm(g9[sl].float(), win[sl].float().transpose(1, 2))
    return out


def dots2_plain(g9, win):
    """Plain K6 dot_kernel2: the first 256 rows of each window, bf16 out."""
    return dots_plain(g9, win[:, :DOTS2_W]).bfloat16()


def slab_plain(g9, fmap, by, bx):
    """Plain K6 fused_kernel: one map (H, W, C), a 16 x 16 window per edge
    at (by, bx), (E, 9, 256) bf16."""
    return window_dots(g9, fmap[None], None, by, bx, SLAB,
                       SLAB * SLAB).bfloat16()


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check_bf16(dev, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError(f'{name} must be bf16 on {dev}, got {t.dtype} on '
                            f'{t.device}')
        if t.shape[-1] != C or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous, 16-byte aligned, '
                             f'with {C} channels last, got '
                             f'{tuple(t.shape)}')


def _check_int(dev, E, **tensors):
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.int32 or t.shape != (E,) \
                or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous ({E},) int32 on '
                             f'{dev}, got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')


def _device(g9):
    """The device of a call: 'cpu' (plain version) or a CUDA device, which
    also builds the library on first use. Raises on any other."""
    dev = g9.device
    if dev.type == 'cuda':
        if _lib is None:
            build()
    elif dev.type != 'cpu':
        raise ValueError(f'unsupported device {dev}')
    return dev


def _check_g9(dev, g9):
    if g9.dim() != 3 or g9.shape[1:] != (P2, C):
        raise ValueError(f'g9 must be (E, {P2}, {C}), got {tuple(g9.shape)}')
    _check_bf16(dev, g9=g9)
    return g9.shape[0]


def _check_maps(dev, g9, fmap1, fmap2, **ints):
    E = _check_g9(dev, g9)
    _check_bf16(dev, fmap1=fmap1, fmap2=fmap2)
    if fmap1.dim() != 4 or fmap2.dim() != 4 or \
            fmap1.shape[0] != fmap2.shape[0]:
        raise ValueError(f'fmap1 / fmap2 must be (F, H, W, {C}) with one F, '
                         f'got {tuple(fmap1.shape)} / {tuple(fmap2.shape)}')
    _check_int(dev, E, **ints)
    return E, (fmap1.shape[0], *fmap1.shape[1:3], *fmap2.shape[1:3])


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launched(key, err):
    if err != 0:
        raise RuntimeError(f'{key} kernel launch failed: CUDA error {err}')
    launches[key] += 1


def _stream(dev):
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def planes_pair(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """K4: K2's planes, two edges per block on the card (see
    planes_pair_plain). CPU tensors take the plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return planes_pair_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    E, shp = _check_maps(dev, g9, fmap1, fmap2, jj=jj, by1=by1, bx1=bx1,
                         by2=by2, bx2=bx2)
    o1 = torch.empty((E, P2, WY * WX), dtype=torch.bfloat16, device=dev)
    o2 = torch.empty((E, P2, WY2 * WX2), dtype=torch.bfloat16, device=dev)
    if E:
        _launched('planes_pair', _lib.probe_planes_pair_launch(
            *map(_ptr, (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, o1, o2)),
            E, *shp, *_stream(dev)))
    return o1, o2


def planes_roll(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, sh1, sh2):
    """K5: K2's planes rolled by the per-edge shifts sh1 / sh2 (see
    planes_roll_plain). CPU tensors take the plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return planes_roll_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2,
                                 sh1, sh2)
    E, shp = _check_maps(dev, g9, fmap1, fmap2, jj=jj, by1=by1, bx1=bx1,
                         by2=by2, bx2=bx2, sh1=sh1, sh2=sh2)
    o1 = torch.empty((E, P2, WY * WX), dtype=torch.bfloat16, device=dev)
    o2 = torch.empty((E, P2, WY2 * WX2), dtype=torch.bfloat16, device=dev)
    if E:
        _launched('planes_roll', _lib.probe_planes_roll_launch(
            *map(_ptr, (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, sh1, sh2,
                        o1, o2)), E, *shp, *_stream(dev)))
    return o1, o2


def planes_first49(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, streams=None):
    """K7: the first 49 f32 plane columns of each level (see
    planes_first49_plain). `streams` = (s1, fr1, s2, fr2, S1, S2) takes
    the probe's STREAMS=1 variant, which also reads s1, s2 (E * 9, 1)
    int32, fr1, fr2 (E * 9, 2) f32 and the f32 blocks S1 (7 * 24, 49),
    S2 (7 * 16, 49); the result does not depend on them. CPU tensors take
    the plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return planes_first49_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    E, shp = _check_maps(dev, g9, fmap1, fmap2, jj=jj, by1=by1, bx1=bx1,
                         by2=by2, bx2=bx2)
    o1 = torch.empty((E * P2, FIRST), dtype=torch.float32, device=dev)
    o2 = torch.empty_like(o1)
    if streams is None:
        key, front, nS, sink = 'planes_first49', (None,) * 6, (0, 0), None
    else:
        s1, fr1, s2, fr2, S1, S2 = streams
        for name, t, dt, shape in (
                ('s1', s1, torch.int32, (E * P2, 1)),
                ('fr1', fr1, torch.float32, (E * P2, 2)),
                ('s2', s2, torch.int32, (E * P2, 1)),
                ('fr2', fr2, torch.float32, (E * P2, 2)),
                ('S1', S1, torch.float32, (7 * WX, FIRST)),
                ('S2', S2, torch.float32, (7 * WX2, FIRST))):
            if t.device != dev or t.dtype != dt or t.shape != shape or \
                    not t.is_contiguous():
                raise ValueError(f'{name} must be contiguous {shape} {dt} on '
                                 f'{dev}, got {tuple(t.shape)} {t.dtype} on '
                                 f'{t.device}')
        sink = torch.empty(E, dtype=torch.int32, device=dev)
        key, front, nS = ('planes_first49_streams', streams,
                          (S1.numel(), S2.numel()))
    if E:
        _launched(key, _lib.probe_planes_first49_launch(
            *map(_ptr, (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, *front)),
            *nS, *map(_ptr, (sink, o1, o2)), E, *shp,
            int(streams is not None), *_stream(dev)))
    return o1, o2


def _w12x16(key, fixed, g9, fmap1, fmap2, jj, bases):
    dev = _device(g9)
    ints = dict(zip(('by1', 'bx1', 'by2', 'bx2'), bases)) if bases else {}
    E, shp = _check_maps(dev, g9, fmap1, fmap2, jj=jj, **ints)
    n = WV[0] * WV[1]
    o1 = torch.empty((E, P2, n), dtype=torch.bfloat16, device=dev)
    o2 = torch.empty_like(o1)
    if E:
        _launched(key, _lib.probe_planes_w12x16_launch(
            *map(_ptr, (g9, fmap1, fmap2, jj, *(bases or (None,) * 4), o1,
                        o2)), E, *shp, int(fixed), *_stream(dev)))
    return o1, o2


def planes_w12x16(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """K8 (full / twodots / rank3): 12 x 16 windows at both levels (see
    planes_w12x16_plain). CPU tensors take the plain version."""
    if g9.device.type == 'cpu':
        return planes_w12x16_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    return _w12x16('planes_w12x16', False, g9, fmap1, fmap2, jj,
                   (by1, bx1, by2, bx2))


def planes_fixedw(g9, fmap1, fmap2, jj):
    """K8 fixedw: 12 x 16 windows at (0, 0) of each edge's frame. CPU
    tensors take the plain version."""
    if g9.device.type == 'cpu':
        return planes_fixedw_plain(g9, fmap1, fmap2, jj)
    return _w12x16('planes_fixedw', True, g9, fmap1, fmap2, jj, None)


def dots_shape(key, E, device=0):
    """The launch shape of K6 `key` ('dots' or 'dots2') for E edges, as
    the CUDA runtime reports it: grid, threads, smem (dynamic bytes), regs,
    resident (blocks per SM), and its ring (csrc/corr_probes.cu:DotsRing):
    stages, rows per stage, consumer warps."""
    if _lib is None:
        build()
    variant, n = {'dots': (0, DOTS_W), 'dots2': (1, DOTS2_W)}[key]
    info = (ctypes.c_int * 8)()
    err = _lib.probe_dots_shape(variant, n, E, device, info)
    if err != 0:
        raise RuntimeError(f'probe_dots_shape: CUDA error {err}')
    return dict(zip(('grid', 'threads', 'smem', 'regs', 'resident',
                     'stages', 'rows', 'warps'), info))


def _dots(key, variant, n, out_dtype, g9, win):
    dev = _device(g9)
    E = _check_g9(dev, g9)
    _check_bf16(dev, win=win)
    if win.dim() != 3 or win.shape[0] != E or win.shape[1] < n:
        raise ValueError(f'win must be ({E}, >= {n}, {C}), got '
                         f'{tuple(win.shape)}')
    out = torch.empty((E, P2, n), dtype=out_dtype, device=dev)
    if E:
        _launched(key, _lib.probe_dots_launch(
            g9.data_ptr(), win.data_ptr(), out.data_ptr(), E, win.shape[1],
            variant, *_stream(dev)))
    return out


def dots(g9, win):
    """K6 dot_kernel: (E, 9, 384) f32 = g9 @ win^T per edge, win (E, 384,
    C). CPU tensors take dots_plain."""
    if g9.device.type == 'cpu':
        return dots_plain(g9, win)
    if win.dim() != 3 or win.shape[1] != DOTS_W:
        raise ValueError(f'win must have {DOTS_W} rows, got '
                         f'{tuple(win.shape)}')
    return _dots('dots', 0, DOTS_W, torch.float32, g9, win)


def dots2(g9, win):
    """K6 dot_kernel2: the first 256 rows of each window of win (E, W >=
    256, C), (E, 9, 256) bf16. CPU tensors take dots2_plain."""
    if g9.device.type == 'cpu':
        return dots2_plain(g9, win)
    return _dots('dots2', 1, DOTS2_W, torch.bfloat16, g9, win)


def slab(g9, fmap, by, bx):
    """K6 fused_kernel: (E, 9, 256) bf16 from a 16 x 16 window per edge of
    one resident map fmap (H, W, C) (see slab_plain). CPU tensors take the
    plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return slab_plain(g9, fmap, by, bx)
    E = _check_g9(dev, g9)
    _check_bf16(dev, fmap=fmap)
    if fmap.dim() != 3:
        raise ValueError(f'fmap must be (H, W, {C}), got {tuple(fmap.shape)}')
    _check_int(dev, E, by=by, bx=bx)
    out = torch.empty((E, P2, SLAB * SLAB), dtype=torch.bfloat16, device=dev)
    if E:
        _launched('slab', _lib.probe_slab_launch(
            g9.data_ptr(), fmap.data_ptr(), by.data_ptr(), bx.data_ptr(),
            out.data_ptr(), E, fmap.shape[0], fmap.shape[1], *_stream(dev)))
    return out
