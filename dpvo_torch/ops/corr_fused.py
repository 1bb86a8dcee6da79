"""Fused two-level correlation: per-edge planes, then a tap select.

Port of dpvo_tpu/ops/corr_fused.py:corr_fused. The same op as ops/corr.py
(both pyramid levels; level 2 at coords / 4), computed in two passes:

  1. `planes` (K2, replacing dpvo_tpu/ops/corr_fused.py:_plane_kernel):
     per edge, the dot of its 9 source-patch pixels with every pixel of a
     fixed window of the target frame -- 12 x 24 at level 1, 10 x 16 at
     level 2 -- as bf16 planes (f32 accumulation; bf16 whatever the maps'
     dtype, as in dpvo_tpu). Two kernels of csrc/corr_fused.cu serve it:
     bf16 maps launch `corr_planes_ring` (a persistent grid; window rows
     streamed into a shared-memory ring by bulk copies, dots on the tensor
     cores; its launch shape is `planes_shape`), f32 maps
     `corr_planes_kernel` (f32 FMAs).
  2. `select_taps` (K3, csrc/corr_fused.cu:corr_select_kernel, replacing
     dpvo_tpu/ops/corr_select.py:_sel_kernel): per pixel, the 8 x 8 tap
     block at its window offset, bilinear to 7 x 7 in f32, taps outside the
     image zeroed.

`window_base` is the window rule of dpvo_tpu (`_window_base`) in image
coordinates: it is semantics, not layout -- a pixel whose 3 x 3 patch spread
overflows the window (y spread > 4 px, x spread > 5 px at the feature scale)
gets zero taps, where ops/corr.py would not.

Each kernel has its plain PyTorch version here (`planes_plain`,
`select_plain`). For tensors on the CPU the wrappers run those; for CUDA
tensors they launch the kernel or raise. Launch counts: `plane_launches`,
`select_launches`. The library is compiled from the checkout's source on
first use (ops/cuda_lib.py).

Below D_MIN (16 px) at either level the windows do not fit the map and
corr_fused takes the exact correlation instead, as dpvo_tpu does: the plain
ops/corr.py on the CPU, the one-pass kernel (ops/corr_onepass.py) on the
card. dpvo_tpu's gate also sends maps with more than 256 frames, or whose
padded size overflows its 10-bit / 8-bit packed scalars, to that path;
those limits came from the TPU's bit-packed SMEM streams, which the port
does not have, so they are gone. The kernels read the source patches as
gmap[kk] directly, so no pre-gathered `g9` is taken.
"""
from __future__ import annotations

import ctypes

import torch

from . import corr_onepass, cuda_lib

RADIUS = 3
P2 = 9
C = 128
WY, WX = 12, 24        # level-1 window: 8 taps + 4 rows / 7 + 5 cols slack
WY2, WX2 = 10, 16      # level-2 window: 8 taps + 2 rows / 3 + 5 cols slack
D_MIN = 16             # below this map size: the exact correlation
_CHUNK = 512           # edges per chunk of the plain planes (~117 MB f32)
# the ring of K2's bf16 kernel (csrc/corr_fused.cu:PlanesRing): stages of
# RING_ROWS window positions, RING_WARPS consumer warps
RING_STAGES, RING_ROWS, RING_WARPS = 3, 64, 4

# kernel launches (plain counts; callers reset them)
plane_launches = 0
select_launches = 0

_lib = None


# the C entries of csrc/corr_fused.cu and their argument types
SIGNATURES = {
    'corr_planes_launch': ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 +
                           [ctypes.c_void_p]),
    'corr_planes_shape': [ctypes.c_int] * 2 + [ctypes.c_void_p],
    'corr_select_launch': ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 +
                           [ctypes.c_void_p]),
}


def build():
    """Compile (once per source hash) and load csrc/corr_fused.cu. Returns
    the path of the shared library (ptxas log beside it as .log)."""
    global _lib
    lib, so = cuda_lib.load('corr_fused')
    if _lib is None:
        _lib = cuda_lib.bind(lib, SIGNATURES)
    return so


# ---------------------------------------------------------------------------
# the window rule
# ---------------------------------------------------------------------------

def window_base(coords, H, W, align):
    """Per-pixel int / fraction parts and per-edge window bases.

    coords (E, 3, 3, 2) [x, y] at this level's scale. Integer coords are
    clamped to [-7, dim + 7] (where the clamp binds every tap of the pixel
    lies outside the map, so results do not change), in float before the
    int conversion: coords far outside the map would overflow int32 (NaN
    converts to 0, as XLA's convert does). by = min(yi) - 3, bx = floor((min
    (xi) - 3) / align) * align (floor division: bx goes negative). Returns
    xi, yi (E, 9) int32, fx, fy (E, 9) f32, by, bx (E,) int32, oy, ox
    (E, 9) int32 -- each pixel's offset inside its edge's window."""
    E = coords.shape[0]
    c = coords.reshape(E, P2, 2).float()
    cf = torch.floor(c)
    fx = c[..., 0] - cf[..., 0]
    fy = c[..., 1] - cf[..., 1]
    ci = torch.nan_to_num(cf, nan=0.0)
    xi = ci[..., 0].clamp(-7, W + 7).to(torch.int32)
    yi = ci[..., 1].clamp(-7, H + 7).to(torch.int32)
    by = yi.amin(1) - RADIUS
    bx = torch.div(xi.amin(1) - RADIUS, align, rounding_mode='floor') * align
    oy = yi - RADIUS - by[:, None]
    ox = xi - RADIUS - bx[:, None]
    return xi, yi, fx, fy, by, bx, oy, ox


# ---------------------------------------------------------------------------
# K2: planes
# ---------------------------------------------------------------------------

def planes_plain(g, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2):
    """Plain version of K2. g (Ng, 9, C); fmap1 / fmap2 (F, H, W, C); kk, jj,
    by*, bx* (E,) int. Returns (E, 9, 12, 24) and (E, 9, 10, 16) bf16:
    plane[e, p, wy, wx] = g[kk[e], p] . fmap[jj[e], by + wy, bx + wx] in
    f32, 0 outside the map (and for an edge whose kk or jj is out of
    range), rounded to bf16."""
    E = kk.shape[0]
    Ng, F = g.shape[0], fmap1.shape[0]
    dev = g.device
    kk, jj = kk.long(), jj.long()
    ok = (kk >= 0) & (kk < Ng) & (jj >= 0) & (jj < F)
    out = []
    for fm, by, bx, wy, wx in ((fmap1, by1, bx1, WY, WX),
                               (fmap2, by2, bx2, WY2, WX2)):
        _, H, W, _ = fm.shape
        rows = fm.reshape(-1, C)
        ay = torch.arange(wy, device=dev)
        ax = torch.arange(wx, device=dev)
        plane = torch.empty((E, P2, wy, wx), dtype=torch.bfloat16,
                            device=dev)
        for s in range(0, E, _CHUNK):
            sl = slice(s, s + _CHUNK)
            y = by[sl].long()[:, None, None] + ay[:, None]        # (n, wy, 1)
            x = bx[sl].long()[:, None, None] + ax                 # (n, 1, wx)
            valid = ((y >= 0) & (y < H) & (x >= 0) & (x < W) &
                     ok[sl, None, None])
            idx = ((jj[sl].clamp(0, F - 1)[:, None, None] * H +
                    y.clamp(0, H - 1)) * W + x.clamp(0, W - 1))
            n = idx.shape[0]
            win = rows.index_select(0, idx.reshape(-1)).reshape(
                n, wy * wx, C).float()
            gk = g[kk[sl].clamp(0, Ng - 1)].float()               # (n, 9, C)
            pl = torch.bmm(gk, win.transpose(1, 2))               # (n, 9, wy*wx)
            pl = torch.where(valid.reshape(n, 1, wy * wx), pl, 0.0)
            plane[sl] = pl.reshape(n, P2, wy, wx).to(torch.bfloat16)
        out.append(plane)
    return tuple(out)


def ring_smem():
    """Dynamic shared memory of K2's bf16 kernel per block, in bytes: the
    ring's stages of 256-byte channel rows, two slots of an edge's 9 g rows
    and its four window bases, and 8-byte barriers (full and empty per
    stage, two per slot)."""
    return (RING_STAGES * RING_ROWS * C * 2 + 2 * (P2 * C * 2 + 16) +
            8 * (2 * RING_STAGES + 4))


def window_rows(kk, jj, by1, bx1, by2, bx2, Ng, F, H1, W1, H2, W2):
    """(E,) int64: the window positions of each edge that lie inside the
    map, at both levels -- the 256-byte channel rows K2's bf16 kernel copies
    for it (0 for an edge whose kk or jj is out of range)."""
    kk, jj = kk.long(), jj.long()
    ok = (kk >= 0) & (kk < Ng) & (jj >= 0) & (jj < F)
    n = torch.zeros_like(kk)
    for by, bx, wy, wx, H, W in ((by1, bx1, WY, WX, H1, W1),
                                 (by2, bx2, WY2, WX2, H2, W2)):
        y = by.long()[:, None] + torch.arange(wy, device=kk.device)
        x = bx.long()[:, None] + torch.arange(wx, device=kk.device)
        n += ((y >= 0) & (y < H)).sum(1) * ((x >= 0) & (x < W)).sum(1)
    return torch.where(ok, n, 0)


def _check_int(name, t, E, dev):
    if t.device != dev or t.dtype != torch.int32 or t.shape != (E,) \
            or not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous ({E},) int32 on {dev}, '
                         f'got {tuple(t.shape)} {t.dtype} on {t.device}')


def planes_shape(E, device=0):
    """The launch shape of K2 for bf16 maps and E edges (csrc/corr_fused.cu:
    corr_planes_ring), as the CUDA runtime reports it on `device`: grid,
    threads, smem (dynamic bytes), regs, resident (blocks per SM), and its
    ring (PlanesRing): stages, rows (window positions per stage), warps
    (consumer warps)."""
    if _lib is None:
        build()
    info = (ctypes.c_int * 8)()
    err = _lib.corr_planes_shape(E, device, info)
    if err != 0:
        raise RuntimeError(f'corr_planes_shape: CUDA error {err}')
    return dict(zip(('grid', 'threads', 'smem', 'regs', 'resident',
                     'stages', 'rows', 'warps'), info))


def planes(g, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2):
    """K2: the correlation planes of both levels (see planes_plain), one
    launch on the card: corr_planes_ring for bf16 maps, corr_planes_kernel
    for f32. CPU tensors take planes_plain."""
    global plane_launches
    dev = g.device
    if dev.type == 'cpu':
        return planes_plain(g, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    if g.dim() != 3 or g.shape[1:] != (P2, C):
        raise ValueError(f'g must be (Ng, {P2}, {C}), got {tuple(g.shape)}')
    for name, t in (('g', g), ('fmap1', fmap1), ('fmap2', fmap2)):
        if t.device != dev or t.dtype != g.dtype:
            raise TypeError(f'{name} must be {g.dtype} on {dev}, got '
                            f'{t.dtype} on {t.device}')
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f'{name} must be bf16 or f32, got {t.dtype}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    for name, t in (('fmap1', fmap1), ('fmap2', fmap2)):
        if t.dim() != 4 or t.shape[-1] != C or t.shape[0] != fmap1.shape[0]:
            raise ValueError(f'{name} must be (F, H, W, {C}) with the frames '
                             f'of fmap1, got {tuple(t.shape)}')
    E = kk.shape[0]
    for name, t in (('kk', kk), ('jj', jj), ('by1', by1), ('bx1', bx1),
                    ('by2', by2), ('bx2', bx2)):
        _check_int(name, t, E, dev)
    p1 = torch.empty((E, P2, WY, WX), dtype=torch.bfloat16, device=dev)
    p2 = torch.empty((E, P2, WY2, WX2), dtype=torch.bfloat16, device=dev)
    if E == 0:
        return p1, p2
    if _lib is None:
        build()
    err = _lib.corr_planes_launch(
        g.data_ptr(), fmap1.data_ptr(), fmap2.data_ptr(), kk.data_ptr(),
        jj.data_ptr(), by1.data_ptr(), bx1.data_ptr(), by2.data_ptr(),
        bx2.data_ptr(), p1.data_ptr(), p2.data_ptr(), E, g.shape[0],
        fmap1.shape[0], fmap1.shape[1], fmap1.shape[2], fmap2.shape[1],
        fmap2.shape[2], int(g.dtype == torch.bfloat16), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'corr_planes kernel launch failed: CUDA error '
                           f'{err}')
    plane_launches += 1
    return p1, p2


# ---------------------------------------------------------------------------
# K3: tap select
# ---------------------------------------------------------------------------

def select_plain(plane, yi, xi, fy, fx, oy, ox, H, W):
    """Plain version of K3, in f32 like dpvo_tpu's _sel_kernel. plane (E, 9,
    Wy, Wx); yi, xi, oy, ox (E, 9) int; fy, fx (E, 9) f32; H, W the level's
    map size. Returns (E, 7, 7, 3, 3) f32, layout [dx, dy, py, px]."""
    E, _, Wy, Wx = plane.shape
    D = 2 * RADIUS + 2
    d = 2 * RADIUS + 1
    dev = plane.device
    r = torch.arange(D, device=dev)
    # a block that does not fit the window: spread overflow, zero taps
    fits = (oy >= 0) & (oy <= Wy - D) & (ox >= 0) & (ox <= Wx - D)
    oyc = torch.where(fits, oy, 0).long()
    oxc = torch.where(fits, ox, 0).long()
    idx = ((oyc[..., None, None] + r[:, None]) * Wx +
           oxc[..., None, None] + r).reshape(E, P2, D * D)
    blk = torch.gather(plane.float().reshape(E, P2, Wy * Wx), 2,
                       idx).reshape(E, P2, D, D)
    ty = yi[..., None].long() - RADIUS + r                    # (E, 9, 8)
    tx = xi[..., None].long() - RADIUS + r
    vy = ((ty >= 0) & (ty < H)).float()
    vx = ((tx >= 0) & (tx < W)).float()
    fy = fy.float()[..., None]
    fx = fx.float()[..., None]
    ay = (1.0 - fy) * vy[..., :d]             # weight of block row i
    by = fy * vy[..., 1:]                     # weight of block row i + 1
    ax = (1.0 - fx) * vx[..., :d]
    bx = fx * vx[..., 1:]
    t1 = ay[..., None] * blk[..., :d, :] + by[..., None] * blk[..., 1:, :]
    out = ax[..., None, :] * t1[..., :d] + bx[..., None, :] * t1[..., 1:]
    out = torch.where(fits[..., None, None], out, 0.0)        # (E, 9, dy, dx)
    return out.reshape(E, 3, 3, d, d).permute(0, 4, 3, 1, 2).contiguous()


def select_taps(plane, yi, xi, fy, fx, oy, ox, H, W):
    """K3: the tap select of one level (see select_plain), one launch on
    the card. CPU tensors take select_plain."""
    global select_launches
    dev = plane.device
    if dev.type == 'cpu':
        return select_plain(plane, yi, xi, fy, fx, oy, ox, H, W)
    if dev.type != 'cuda':
        raise ValueError(f'unsupported device {dev}')
    E = plane.shape[0]
    level = {(WY, WX): 1, (WY2, WX2): 2}.get(tuple(plane.shape[2:]))
    if (plane.dim() != 4 or plane.shape[1] != P2 or level is None
            or plane.dtype != torch.bfloat16 or not plane.is_contiguous()):
        raise ValueError(f'plane must be contiguous bf16 (E, {P2}, {WY}, '
                         f'{WX}) or (E, {P2}, {WY2}, {WX2}), got '
                         f'{tuple(plane.shape)} {plane.dtype}')
    if E * (2 * RADIUS + 1) ** 2 * P2 >= 2 ** 31:
        raise ValueError(f'{E} edges overflow the kernel\'s int32 index')
    for name, t, dt in (('yi', yi, torch.int32), ('xi', xi, torch.int32),
                        ('fy', fy, torch.float32), ('fx', fx, torch.float32),
                        ('oy', oy, torch.int32), ('ox', ox, torch.int32)):
        if t.device != dev or t.dtype != dt or t.shape != (E, P2) \
                or not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous ({E}, {P2}) {dt} on '
                             f'{dev}, got {tuple(t.shape)} {t.dtype} on '
                             f'{t.device}')
    d = 2 * RADIUS + 1
    out = torch.empty((E, d, d, 3, 3), dtype=torch.float32, device=dev)
    if E == 0:
        return out
    if _lib is None:
        build()
    err = _lib.corr_select_launch(
        plane.data_ptr(), yi.data_ptr(), xi.data_ptr(), fy.data_ptr(),
        fx.data_ptr(), oy.data_ptr(), ox.data_ptr(), out.data_ptr(), E,
        int(H), int(W), level, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f'corr_select kernel launch failed: CUDA error '
                           f'{err}')
    select_launches += 1
    return out


# ---------------------------------------------------------------------------
# both passes
# ---------------------------------------------------------------------------

def corr_fused(gmap, fmap1, fmap2, coords, kk, jj):
    """Both-level local correlation through the planes (K2) + select (K3)
    passes; on the CPU through their plain versions.

    gmap (Ng, 3, 3, C) source patches; fmap1 (F, H1, W1, C), fmap2 (F, H2,
    W2, C) target maps, channels-last, bf16 or f32 (one dtype); coords
    (E, 3, 3, 2) f32 at level-1 scale; kk (E,) rows of gmap, jj (E,) frames
    of the maps (int32 on the card). Edges sorted by jj keep a target
    frame's maps in L2 (not required). Returns (c1, c2), each
    (E, 7, 7, 3, 3) f32 [dx, dy, py, px]."""
    E = coords.shape[0]
    H1, W1 = fmap1.shape[1:3]
    H2, W2 = fmap2.shape[1:3]
    if min(H1, H2, W1, W2) < D_MIN:
        c = corr_onepass.corr_two_level(gmap, fmap1, fmap2, coords, kk, jj)
        return c[..., 0], c[..., 1]

    xi1, yi1, fx1, fy1, by1, bx1, oy1, ox1 = window_base(coords, H1, W1, 8)
    xi2, yi2, fx2, fy2, by2, bx2, oy2, ox2 = window_base(coords / 4.0, H2,
                                                         W2, 4)
    g = gmap.reshape(gmap.shape[0], P2, gmap.shape[-1])
    plane1, plane2 = planes(g, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2)
    c1 = select_taps(plane1, yi1, xi1, fy1, fx1, oy1, ox1, H1, W1)
    c2 = select_taps(plane2, yi2, xi2, fy2, fx2, oy2, ox2, H2, W2)
    return c1, c2
