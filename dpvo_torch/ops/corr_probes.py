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

K5, K7 and K8 run on K2's design (csrc/planes_ring.cuh, shared with
ops/corr_fused.py's bf16 kernel): a persistent grid, window rows streamed
into a shared-memory ring by bulk copies, dots on the tensor cores; each
instantiation's ring is fixed at compile time (PLANES_RING) and its launch
shape is `planes_ring_shape`. K4 bins its edges by target tile on the
device and stages each tile's map rows once per work item of up to
PAIR_CAP edges (PAIR_TILE, `pair_shape`; `pair_work` reads the items of
one call back). K6 slab runs the same binning at one level with its edges
sorted by row base inside each bin, and computes each tile row's products
for the run of edges whose windows hold it as one GEMM (SLAB_TILE,
`slab_shape`; `slab_work` reads the items of one call back).

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
import math

import torch

from . import cuda_lib

P2 = 9
C = 128
WY, WX = 12, 24          # K2's level-1 window (K4, K5, K7)
WY2, WX2 = 10, 16        # K2's level-2 window
WV = (12, 16)            # K8's window at both levels
FIRST = 49               # K7 keeps the first 49 columns of each level
FIRST_POS = 64           # ... of the first 64 positions of its ring,
FIRST_LIVE = 56          # ... of which the tiles that hold them are copied
DOTS_W = 384             # K6 dot_kernel's window rows
DOTS2_W = 256            # K6 dot_kernel2 reads the first 256 of them
SLAB = 16                # K6 fused_kernel's 16 x 16 window
_CHUNK = 512             # edges per chunk of the plain versions
# the ring of each instantiation on K2's design (csrc/corr_probes.cu:
# ProbeRing): stages, window positions per stage, consumer warps, blocks
# asked for on each SM
PLANES_RING = {'planes_roll': (3, 64, 2, 4), 'planes_w12x16': (3, 64, 2, 4),
               'planes_fixedw': (3, 64, 2, 4),
               'planes_first49': (2, 128, 4, 3),
               'planes_first49_streams': (2, 128, 4, 3)}
_RING_WHICH = {'planes_roll': 0, 'planes_w12x16': 1, 'planes_fixedw': 2,
               'planes_first49': 3, 'planes_first49_streams': 4}
FIRST49 = ('planes_first49', 'planes_first49_streams')
# K4's tile per level (csrc/corr_probes.cu:PairTile): map rows at most,
# consumer warps, blocks asked for on each SM, tile pairs per unit of work;
# edges per work item at most
PAIR_TILE = {1: (15, 4, 2, 9), 2: (30, 8, 1, 10)}
PAIR_CAP = 64
# K6 slab's tile (csrc/corr_probes.cu:SlabTile): map rows at most, edges
# per work item at most, consumer warps, blocks asked for on each SM, tile
# rows per unit of work, m16 tiles per unit at most and per pass
SLAB_TILE = (18, 16, 5, 2, 2, 12, 2)

launches = dict.fromkeys((
    'planes_pair', 'planes_roll', 'dots', 'dots2', 'slab', 'planes_first49',
    'planes_first49_streams', 'planes_w12x16', 'planes_fixedw'), 0)

_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries of csrc/corr_probes.cu and their argument types
SIGNATURES = {
    'probe_planes_pair_launch': [_P] * 11 + [_I] * 7 + [_P],
    'probe_planes_pair_scratch': [_I] * 6,
    'probe_planes_pair_items': [_I] * 6 + [_P],
    'probe_planes_pair_shape': [_I] * 3 + [_P],
    'probe_planes_roll_launch': [_P] * 12 + [_I] * 7 + [_P],
    'probe_planes_first49_launch': ([_P] * 14 + [_I] * 2 + [_P] * 3 +
                                    [_I] * 8 + [_P]),
    'probe_planes_w12x16_launch': [_P] * 10 + [_I] * 8 + [_P],
    'probe_planes_ring_shape': [_I] * 3 + [_P],
    'probe_dots_launch': [_P] * 3 + [_I] * 4 + [_P],
    'probe_dots_shape': [_I] * 4 + [_P],
    'probe_slab_launch': [_P] * 6 + [_I] * 4 + [_P],
    'probe_slab_scratch': [_I] * 3,
    'probe_slab_items': [_I] * 3 + [_P],
    'probe_slab_shape': [_I] * 2 + [_P],
}


def build():
    """Compile (once per source hash) and load csrc/corr_probes.cu. Returns
    the path of the shared library (ptxas log beside it as .log)."""
    global _lib
    lib, so = cuda_lib.load('corr_probes')
    if _lib is None:
        _lib = cuda_lib.bind(lib, SIGNATURES)
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


def ring_windows(key):
    """The windows of ring instantiation `key` (a key of PLANES_RING) as
    ((columns, positions copied) of level 1, of level 2): K7 copies the
    first FIRST_LIVE positions of K2's windows."""
    if key == 'planes_roll':
        return (WX, WY * WX), (WX2, WY2 * WX2)
    if key in FIRST49:
        return (WX, FIRST_LIVE), (WX2, FIRST_LIVE)
    return (WV[1], WV[0] * WV[1]), (WV[1], WV[0] * WV[1])


def ring_rows(key, jj, by1, bx1, by2, bx2, F, H1, W1, H2, W2):
    """(E,) int64: the window positions of each edge that lie inside the
    map, at both levels, for instantiation `key` of PLANES_RING (for
    planes_fixedw pass zero bases) -- the 256-byte channel rows its ring
    copies for the edge (0 for an edge whose jj is out of range)."""
    jj = jj.long()
    n = torch.zeros_like(jj)
    for by, bx, (wx, npos), H, W in zip((by1, by2), (bx1, bx2),
                                        ring_windows(key), (H1, H2),
                                        (W1, W2)):
        q = torch.arange(npos, device=jj.device)
        y = by.long()[:, None] + q // wx
        x = bx.long()[:, None] + q % wx
        n += ((y >= 0) & (y < H) & (x >= 0) & (x < W)).sum(1)
    return torch.where((jj >= 0) & (jj < F), n, 0)


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


def _pair_chain(dev, g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """K4's chain on CUDA tensors: (plane1, plane2, its int32 scratch or
    None for no edges, E, the maps' shapes)."""
    E, shp = _check_maps(dev, g9, fmap1, fmap2, jj=jj, by1=by1, bx1=bx1,
                         by2=by2, bx2=bx2)
    o1 = torch.empty((E, P2, WY * WX), dtype=torch.bfloat16, device=dev)
    o2 = torch.empty((E, P2, WY2 * WX2), dtype=torch.bfloat16, device=dev)
    scratch = None
    if E:
        words = _lib.probe_planes_pair_scratch(E, *shp)
        if words < 0:
            raise ValueError(f'planes_pair: maps {shp} give more bins than '
                             'int32 counts')
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        _launched('planes_pair', _lib.probe_planes_pair_launch(
            *map(_ptr, (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, o1, o2,
                        scratch)), E, *shp, *_stream(dev)))
    return o1, o2, scratch, E, shp


def planes_pair(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """K4: K2's planes with g rows g9[e] (see planes_pair_plain), on the
    card as target tiles: the edges binned by tile on the device, each
    tile's map rows staged once per work item; one chain of kernels on the
    current stream, with no synchronize. Edges need not be sorted. CPU
    tensors take the plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return planes_pair_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    return _pair_chain(dev, g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)[:2]


def pair_work(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2):
    """K4's work items as its chain makes them on the card: one call of
    planes_pair's chain (one launch) on CUDA tensors, then its scratch read
    back (a synchronize; for checks and reports, never on the path).
    Returns [items of level 1, of level 2], each (n, 4) int64 on the CPU in
    the kernel's order: first position in the edges sorted by bin, edges,
    bin (the last bin: the edges that write zeros), the positions of the
    bin's tile that lie in the map (0 for the zero bin)."""
    dev = _device(g9)
    if dev.type != 'cuda':
        raise ValueError('pair_work reads the items of a launch on the card')
    _, _, scratch, E, shp = _pair_chain(dev, g9, fmap1, fmap2, jj, by1, bx1,
                                        by2, bx2)
    if scratch is None:
        return [torch.zeros((0, 4), dtype=torch.int64)] * 2
    info = (ctypes.c_int * 4)()
    if _lib.probe_planes_pair_items(E, *shp, info) != 0:
        raise ValueError(f'planes_pair: maps {shp} give more bins than '
                         'int32 counts')
    host = scratch.cpu()
    return [host[info[2 * l]:info[2 * l] + 4 * int(host[info[2 * l + 1]])]
            .reshape(-1, 4).long() for l in range(2)]


def tile_stats(work):
    """What a target-tile chain reads from L2 per call, from its work items
    (a list of item arrays: pair_work's, or [slab_work's]): {'items',
    'edges_per_item' (mean), 'tile_bytes' (each item's tile in the map,
    every level), 'g_bytes' (the g rows of the edges of items that copy a
    tile)}."""
    items = torch.cat(work)
    n = max(len(items), 1)
    tiled = items[:, 3] > 0
    return dict(items=len(items), edges_per_item=int(items[:, 1].sum()) / n,
                tile_bytes=int(items[:, 3].sum()) * C * 2,
                g_bytes=int(items[tiled, 1].sum()) * P2 * C * 2)


def planes_roll(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2, sh1, sh2):
    """K5: K2's planes rolled by the per-edge shifts sh1 / sh2, any int32
    (see planes_roll_plain), on K2's ring on the card. CPU tensors take the
    plain version."""
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
    planes_first49_plain), on K2's ring on the card. `streams` = (s1, fr1,
    s2, fr2, S1, S2) takes the probe's STREAMS=1 variant, which also reads
    s1, s2 (E * 9, 1) int32, fr1, fr2 (E * 9, 2) f32 and the f32 blocks
    S1 (7 * 24, 49), S2 (7 * 16, 49); the result does not depend on them.
    CPU tensors take the plain version."""
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
    planes_w12x16_plain), on K2's ring on the card. CPU tensors take the
    plain version."""
    if g9.device.type == 'cpu':
        return planes_w12x16_plain(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    return _w12x16('planes_w12x16', False, g9, fmap1, fmap2, jj,
                   (by1, bx1, by2, bx2))


def planes_fixedw(g9, fmap1, fmap2, jj):
    """K8 fixedw: 12 x 16 windows at (0, 0) of each edge's frame, on K2's
    ring on the card. CPU tensors take the plain version."""
    if g9.device.type == 'cpu':
        return planes_fixedw_plain(g9, fmap1, fmap2, jj)
    return _w12x16('planes_fixedw', True, g9, fmap1, fmap2, jj, None)


def ring_smem(key):
    """Dynamic shared memory per block of instantiation `key` on the ring
    (a key of PLANES_RING), in bytes: the stages of 256-byte channel rows,
    two slots of an edge's 9 g rows, its four window bases (and for
    planes_roll its two rolls, padded to 16 bytes), 8-byte barriers (full
    and empty per stage, two per slot) and, for K7, a slot of 9 x 16 f32
    per consumer warp."""
    stages, rows, warps = PLANES_RING[key][:3]
    slot = P2 * C * 2 + (32 if key == 'planes_roll' else 16)
    pairs = warps * P2 * 16 * 4 if key in FIRST49 else 0
    return stages * rows * C * 2 + 2 * slot + 8 * (2 * stages + 4) + pairs


def pair_gslots(level):
    """The g slots per block of K4's tile kernel at `level`
    (csrc/corr_probes.cu:PairLevel::kGSlots): at least 4, and a multiple of
    warps / gcd(warps, units per edge), so that each slot's uses belong to
    the same warps."""
    wy, wx = (WY, WX) if level == 1 else (WY2, WX2)
    warps, unit = PAIR_TILE[level][1], PAIR_TILE[level][3]
    units = wy * wx // 16 // unit
    return max(4, warps // math.gcd(warps, units))


def pair_smem(level):
    """Dynamic shared memory per block of K4's tile kernel at `level`, in
    bytes: the tile (map rows x the window's columns of 256-byte channel
    rows), pair_gslots slots of an edge's 9 g rows and (edge, by) padded to
    16 bytes, the item (16 bytes), and 8-byte barriers (the tile's full
    and empty, two per slot)."""
    wx = WX if level == 1 else WX2
    ng = pair_gslots(level)
    return (PAIR_TILE[level][0] * wx * C * 2 + ng * (P2 * C * 2 + 16) + 16 +
            8 * (2 + 2 * ng))


def pair_shape(level, E, device=0):
    """The launch shape of K4's tile kernel at `level` (1 or 2) for E
    edges, as the CUDA runtime reports it: grid, threads, smem (dynamic
    bytes), regs, resident (blocks per SM), and its tile: rows (map rows
    at most), warps (consumer warps), cap (edges per item at most), unit
    (tile pairs per unit of work)."""
    if _lib is None:
        build()
    info = (ctypes.c_int * 9)()
    err = _lib.probe_planes_pair_shape(level, E, device, info)
    if err != 0:
        raise RuntimeError(f'probe_planes_pair_shape: CUDA error {err}')
    return dict(zip(('grid', 'threads', 'smem', 'regs', 'resident', 'rows',
                     'warps', 'cap', 'unit'), info))


def planes_ring_shape(key, E, device=0):
    """The launch shape of instantiation `key` (a key of PLANES_RING) for E
    edges, as the CUDA runtime reports it: grid, threads, smem (dynamic
    bytes), regs, resident (blocks per SM), and its ring: stages, rows
    (window positions per stage), warps (consumer warps)."""
    if _lib is None:
        build()
    info = (ctypes.c_int * 8)()
    err = _lib.probe_planes_ring_shape(_RING_WHICH[key], E, device, info)
    if err != 0:
        raise RuntimeError(f'probe_planes_ring_shape: CUDA error {err}')
    return dict(zip(('grid', 'threads', 'smem', 'regs', 'resident',
                     'stages', 'rows', 'warps'), info))


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


def _slab_chain(dev, g9, fmap, by, bx):
    """K6 slab's chain on CUDA tensors: (out, its int32 scratch or None
    for no edges, E, (H, W))."""
    E = _check_g9(dev, g9)
    _check_bf16(dev, fmap=fmap)
    if fmap.dim() != 3:
        raise ValueError(f'fmap must be (H, W, {C}), got {tuple(fmap.shape)}')
    _check_int(dev, E, by=by, bx=bx)
    hw = tuple(fmap.shape[:2])
    out = torch.empty((E, P2, SLAB * SLAB), dtype=torch.bfloat16, device=dev)
    scratch = None
    if E:
        words = _lib.probe_slab_scratch(E, *hw)
        if words < 0:
            raise ValueError(f'slab: map {hw} gives more bins than int32 '
                             'counts')
        scratch = torch.empty(words, dtype=torch.int32, device=dev)
        _launched('slab', _lib.probe_slab_launch(
            *map(_ptr, (g9, fmap, by, bx, out, scratch)), E, *hw,
            *_stream(dev)))
    return out, scratch, E, hw


def slab(g9, fmap, by, bx):
    """K6 fused_kernel: (E, 9, 256) bf16 from a 16 x 16 window per edge of
    one resident map fmap (H, W, C) (see slab_plain), any int32 bases. On
    the card as target tiles: the edges binned by (row bin, bx) and sorted
    by by on the device, each tile row's products one GEMM of the run of
    edges whose windows hold it; one chain of kernels on the current
    stream, with no synchronize. CPU tensors take the plain version."""
    dev = _device(g9)
    if dev.type == 'cpu':
        return slab_plain(g9, fmap, by, bx)
    return _slab_chain(dev, g9, fmap, by, bx)[0]


def slab_work(g9, fmap, by, bx):
    """K6 slab's work items as its chain makes them on the card: one call
    of slab's chain (one launch) on CUDA tensors, then its scratch read
    back (a synchronize; for checks and reports, never on the path).
    Returns (n, 4) int64 on the CPU in the kernel's order: first position
    in the edges sorted by bin, edges, coarse bin (the last: the edges that
    write zeros), the positions of the item's tile that lie in the map
    (the map rows of its edges' windows x the in-map columns; 0 for the
    zero bin)."""
    dev = _device(g9)
    if dev.type != 'cuda':
        raise ValueError('slab_work reads the items of a launch on the card')
    _, scratch, E, hw = _slab_chain(dev, g9, fmap, by, bx)
    if scratch is None:
        return torch.zeros((0, 4), dtype=torch.int64)
    info = (ctypes.c_int * 2)()
    if _lib.probe_slab_items(E, *hw, info) != 0:
        raise ValueError(f'slab: map {hw} gives more bins than int32 counts')
    host = scratch.cpu()
    return host[info[0]:info[0] + 4 * int(host[info[1]])].reshape(-1,
                                                                  4).long()


def slab_smem():
    """Dynamic shared memory per block of K6 slab's tile kernel, in bytes:
    the tile (map rows x 16 positions of 256-byte channel rows), the g
    stage (9 rows of 256 B per edge of an item), (edge, by) per edge, 16
    bytes per tile row, the item (32 bytes), the units' claim counter (16
    bytes) and two 8-byte barriers."""
    rows, cap = SLAB_TILE[:2]
    return rows * SLAB * C * 2 + cap * P2 * C * 2 + 8 * cap + 16 * rows + \
        32 + 16 + 16


def slab_shape(E, device=0):
    """The launch shape of K6 slab's tile kernel for E edges, as the CUDA
    runtime reports it: grid, threads, smem (dynamic bytes), regs,
    resident (blocks per SM), and its tile: rows (map rows at most), cap
    (edges per item at most), warps (consumer warps), unit_rows (tile rows
    per unit of work), unit and pass (m16 tiles per unit at most and per
    pass)."""
    if _lib is None:
        build()
    info = (ctypes.c_int * 11)()
    err = _lib.probe_slab_shape(E, device, info)
    if err != 0:
        raise RuntimeError(f'probe_slab_shape: CUDA error {err}')
    return dict(zip(('grid', 'threads', 'smem', 'regs', 'resident', 'rows',
                     'cap', 'warps', 'unit_rows', 'unit', 'pass'), info))
