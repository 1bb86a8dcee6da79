"""K4 (ops/corr_probes.py:planes_pair) and K6 slab (slab) as target tiles
on the CPU: the chains of csrc/corr_probes.cu (bin_count, bin_sums,
bin_scan, bin_scatter, then probe_pair_tiles<1>, <2> or probe_slab_tiles)
emulated in numpy step by step against the plain versions
(planes_pair_plain, slab_plain) and against a vectorised emulation of the
binning (level_keys, level_items; bin_items for K4, slab_items for the
slab; the card's tests hold the items that each chain reads back,
corr_probes.pair_work and slab_work, against them), and their constants
read from the source. The slab's emulation (_slab_tiles) follows its
tile kernel: the runs of edges per group of tile rows, the units and
passes of m16 tiles, each output entry written once.

The emulation follows the kernels:
  * the count: each edge's fine bin at each level, its coarse bin (frame,
    (by + WY - 1) // TY, bx + WX - 1) times G plus, for the slab (G = TY),
    its exact by inside it; the last coarse bin for an edge whose frame is
    out of range or whose window misses the map; the fine bins' counts;
  * the scan: blocks of 1024 consecutive coarse bins, one thread each; the
    sums of each block's edges and items (bin_sums), then per block the
    sums of the blocks before it plus the block's exclusive scans
    (bin_scan), the fine bins' first positions, and a coarse bin of n
    edges giving ceil(n / cap) items (first position, edges, bin, the
    positions of the bin's tile in the map for K4, 0 for the slab, whose
    tile kernel writes them);
  * the scatter: the edges in any order (atomics), each to its fine bin's
    next position as (edge, by);
  * K4's tile kernel: per item the in-map rows of its tile copied into a
    tile poisoned with NaN (stale bytes), the item's edges in sorted order,
    each edge's tile pairs dotted with B read at the edge's own tile row
    (clamped into the tile), the k-steps' channels permuted in A and B
    alike (f32 sums of bf16 inputs per k-step of 16 channels), columns
    outside the map (all of a zero item's) written as zero, each lane's
    two columns of a tile stored as one bf16 pair.
Bound against the plain version: one bf16 rounding of the same f32 sums in
another order, 2^-7 |plain| + 1e-5 max|plain|; entries outside the map
exactly zero; every entry written (no NaN)."""
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_probes as cp
from test_torch_corr_planes_ring import _kstep_channels

SRC = Path(cp.__file__).resolve().parent.parent / 'csrc' / 'corr_probes.cu'
C, P2 = cp.C, cp.P2
SCAN_THREADS = 1024
WINS = {1: (cp.WY, cp.WX), 2: (cp.WY2, cp.WX2)}


def _level(wy, wx, rows, cap, F, H, W, exact):
    """One level of the binning (csrc/corr_probes.cu:level_shape): windows
    wy x wx, tiles of at most `rows` map rows, items of at most `cap`
    edges; the window bases per row bin TY (rows - wy + 1; without `exact`
    a map of at most `rows` rows is one bin), the row bins NYB, the column keys
    NXB (one per base bx whose window meets the map), the coarse bins (the
    last holds the edges that write zeros) and G fine bins per coarse bin
    (TY with `exact`: the exact by; else 1)."""
    ty = H + wy - 1 if H <= rows and not exact else rows - wy + 1
    nyb = -(-(H + wy - 1) // ty)
    nxb = W + wx - 1
    return dict(WY=wy, WX=wx, TY=ty, NYB=nyb, NXB=nxb, G=ty if exact else 1,
                cap=cap, F=F, H=H, W=W, ncoarse=F * nyb * nxb + 1)


def pair_level(level, F, H, W):
    """K4's binning at `level` (PAIR_TILE's rows, PAIR_CAP)."""
    return _level(*WINS[level], cp.PAIR_TILE[level][0], cp.PAIR_CAP, F, H, W,
                  False)


def slab_level(H, W):
    """K6 slab's binning of one H x W map (SLAB_TILE's rows and cap, fine
    bins of exact by)."""
    return _level(cp.SLAB, cp.SLAB, cp.SLAB_TILE[0], cp.SLAB_TILE[1], 1, H,
                  W, True)


def bin_plan(level, F, H, W):
    """K4's binning of `level`: (TY, NYB, NXB, nbins) of pair_level."""
    lv = pair_level(level, F, H, W)
    return lv['TY'], lv['NYB'], lv['NXB'], lv['ncoarse']


def level_keys(lv, jj, by, bx):
    """(E,) int64: each edge's fine bin at level lv (bin_key): coarse bin
    (frame, (by + WY - 1) // TY, bx + WX - 1) in row-major order, times G,
    plus (by + WY - 1) % TY where G > 1; an edge whose frame is out of
    range (jj None: frame 0) or whose window misses the map takes the first
    fine bin of the last coarse bin."""
    by, bx = by.long(), bx.long()
    jj = torch.zeros_like(by) if jj is None else jj.long()
    live = ((jj >= 0) & (jj < lv['F']) & (by > -lv['WY']) & (by < lv['H']) &
            (bx > -lv['WX']) & (bx < lv['W']))
    y = by + lv['WY'] - 1
    r = torch.div(y, lv['TY'], rounding_mode='floor')
    key = ((jj * lv['NYB'] + r) * lv['NXB'] + bx + lv['WX'] - 1) * lv['G']
    if lv['G'] > 1:
        key = key + y - r * lv['TY']
    return torch.where(live, key, (lv['ncoarse'] - 1) * lv['G'])


def bin_keys(level, jj, by, bx, F, H, W):
    """(E,) int64: each edge's bin at K4's `level` (pair_level)."""
    return level_keys(pair_level(level, F, H, W), jj, by, bx)


def _bin_rect(lv, z, kf, kl):
    """bin_rect: the tile of coarse bin z (int or tensor) for the bases of
    its fine rows kf .. kl: (bx, ty0, y0, rows, x0, nx)."""
    div = (lambda a, b: torch.div(a, b, rounding_mode='floor')) \
        if torch.is_tensor(z) else (lambda a, b: a // b)
    r = div(z, lv['NXB'])
    bx = z - r * lv['NXB'] - (lv['WX'] - 1)
    ty0 = (r % lv['NYB']) * lv['TY'] - (lv['WY'] - 1)
    lo = ty0 + kf
    y0 = lo.clamp(min=0) if torch.is_tensor(lo) else max(lo, 0)
    hi = ty0 + kl + lv['WY']
    rows = (hi.clamp(max=lv['H']) if torch.is_tensor(hi) else
            min(hi, lv['H'])) - y0
    x0 = bx.clamp(min=0) if torch.is_tensor(bx) else max(bx, 0)
    nx = ((bx + lv['WX']).clamp(max=lv['W']) if torch.is_tensor(bx) else
          min(bx + lv['WX'], lv['W'])) - x0
    return bx, ty0, y0, rows, x0, nx


def level_items(lv, jj, by, bx):
    """The work items of level lv in the kernel's order (by coarse bin; a
    coarse bin of n edges is ceil(n / cap) items): (items, 4) int64 rows
    (first position in the edges sorted by fine bin, edges, coarse bin,
    positions of the item's tile in the map: the bin's whole tile for G =
    1, the rows of the item's own edges' windows for G > 1; 0 for the zero
    bin)."""
    G, cap, nc = lv['G'], lv['cap'], lv['ncoarse']
    keys = level_keys(lv, jj, by, bx)
    count = torch.bincount(torch.div(keys, G, rounding_mode='floor'),
                           minlength=nc)
    start = torch.cumsum(count, 0) - count
    per = -(-count // cap)
    b = torch.repeat_interleave(torch.arange(nc), per)
    k = torch.arange(len(b)) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    first = start[b] + k * cap
    n = torch.clamp(count[b] - k * cap, max=cap)
    if G > 1:
        fine = torch.sort(keys).values
        kf = fine[first] - b * G if len(b) else first
        kl = fine[first + n - 1] - b * G if len(b) else first
    else:
        kf, kl = torch.zeros_like(b), torch.full_like(b, lv['TY'] - 1)
    _, _, _, rows, _, nx = _bin_rect(lv, b, kf, kl)
    return torch.stack([first, n, b, torch.where(b == nc - 1, 0, rows * nx)],
                       1)


def bin_items(level, jj, by, bx, F, H, W):
    """K4's work items at `level` (level_items), as pair_work reads them
    back."""
    return level_items(pair_level(level, F, H, W), jj, by, bx)


def bin_work(jj, by1, bx1, by2, bx2, F, H1, W1, H2, W2):
    """Both levels' bin_items, as pair_work returns them."""
    return [bin_items(1, jj, by1, bx1, F, H1, W1),
            bin_items(2, jj, by2, bx2, F, H2, W2)]


def slab_items(by, bx, H, W):
    """K6 slab's work items (level_items of slab_level), as slab_work
    reads them back."""
    return level_items(slab_level(H, W), None, by, bx)


def _bin_chain(lv, jj, by, bx, rng):
    """bin_count, bin_sums, bin_scan and bin_scatter at level lv in numpy
    (jj None: frame 0). Returns (items as (n, 4) int64 rows (first, edges,
    coarse bin, tile positions: 0 where G > 1, which the tile kernel
    writes), rec (E, 2) int64 rows (edge, by) in bin order)."""
    wy, wx, ty, nyb, nxb = (lv[k] for k in ('WY', 'WX', 'TY', 'NYB', 'NXB'))
    G, cap, F, H, W, nc = (lv[k] for k in ('G', 'cap', 'F', 'H', 'W',
                                           'ncoarse'))
    E = len(by)
    key = np.empty(E, np.int64)
    count = np.zeros(nc * G, np.int64)
    for e in range(E):                                     # bin_count
        j = 0 if jj is None else jj[e]
        if 0 <= j < F and -wy < by[e] < H and -wx < bx[e] < W:
            y = by[e] + wy - 1
            r = y // ty
            key[e] = ((j * nyb + r) * nxb + bx[e] + wx - 1) * G + \
                (y - r * ty if G > 1 else 0)
        else:
            key[e] = (nc - 1) * G
        count[key[e]] += 1
    cc = count.reshape(nc, G).sum(1)                       # coarse_count
    nblocks = -(-nc // SCAN_THREADS)
    per_bin = -(-cc // cap)
    part = [(int(cc[k * SCAN_THREADS:(k + 1) * SCAN_THREADS].sum()),
             int(per_bin[k * SCAN_THREADS:(k + 1) * SCAN_THREADS].sum()))
            for k in range(nblocks)]                       # bin_sums
    off = np.zeros(nc * G, np.int64)
    items = np.zeros((int(per_bin.sum()), 4), np.int64)
    for k in range(nblocks):                               # bin_scan
        e0 = sum(q[0] for q in part[:k])
        i0 = sum(q[1] for q in part[:k])
        lo, hi = k * SCAN_THREADS, min(nc, (k + 1) * SCAN_THREADS)
        for i in range(lo, hi):    # the block's exclusive scans, thread i
            eo = e0 + int(cc[lo:i].sum())
            io = i0 + int(per_bin[lo:i].sum())
            cnt = count[i * G:(i + 1) * G]
            off[i * G:(i + 1) * G] = eo + np.cumsum(cnt) - cnt
            pos = 0                 # the bin's tile (G = 1; G > 1: later)
            if G == 1 and cc[i] and i != nc - 1:
                rect = _bin_rect(lv, i, 0, ty - 1)
                pos = rect[3] * rect[5]
            for m in range(0, cc[i], cap):
                items[io] = (eo + m, min(cap, cc[i] - m), i, pos)
                io += 1
    rec = np.zeros((E, 2), np.int64)
    for e in rng.permutation(E):                 # atomics: any order
        rec[off[key[e]]] = (e, by[e])
        off[key[e]] += 1
    return items, rec


def _tile_chain(level, g, fmap, jj, by, bx, rng):
    """The whole chain at `level` in numpy: (planes (E, 9, WY * WX) bf16,
    items, rec, tile bytes copied)."""
    wy, wx = WINS[level]
    F, H, W = fmap.shape[:3]
    R = cp.PAIR_TILE[level][0]
    N, tpr = wy * wx, wx // 8
    lv = pair_level(level, F, H, W)
    nbins = lv['ncoarse']
    items, rec = _bin_chain(lv, jj, by, bx, rng)
    E = len(jj)
    out = np.full((E, P2, N), np.nan, np.float32)
    ksteps = _kstep_channels()
    copied = 0
    for first, n, b, pos in items:
        tiled = b != nbins - 1
        tile = np.full((R, wx, C), np.nan, np.float32)   # stale bytes
        y0 = bx0 = 0
        if tiled:                        # the producer's decode and copies
            j = b // lv['NXB'] // lv['NYB']
            bx0, _, y0, rows, x0, nx = _bin_rect(lv, b, 0, lv['TY'] - 1)
            assert 0 < rows <= R and nx > 0
            tile[:rows, x0 - bx0:x0 - bx0 + nx] = \
                fmap[j, y0:y0 + rows, x0:x0 + nx]
            copied += rows * nx
        assert pos == (rows * nx if tiled else 0)   # the item's record
        for e, by_e in rec[first:first + n]:
            a = np.zeros((16, C), np.float32)              # rows 9-15 zero
            a[:P2] = g[e] if tiled else np.nan             # stale g slot
            for tq in range(N // 8):
                wyq, cx = tq // tpr, (tq % tpr) * 8
                y = by_e + wyq
                srow = min(max(y - y0, 0), R - 1)
                B = tile[srow, cx:cx + 8]
                d = np.zeros((16, 8), np.float32)
                for ch in ksteps:
                    d += (a[:, ch] @ B[:, ch].T).astype(np.float32)
                x = bx0 + cx + np.arange(8)
                inside = tiled & (0 <= y < H) & (x >= 0) & (x < W)
                out[e, :, tq * 8:tq * 8 + 8] = np.where(inside, d[:P2], 0.0)
    return torch.from_numpy(out).to(torch.bfloat16), items, rec, copied


def _case(seed, E=60, F=3, H1=48, W1=80, sort=False):
    """bf16-valued g and maps; window bases at every border of each level,
    one past it, far outside (both ends), negative by2 / bx2, wholly
    inside; jj out of range (-1, F) on a few edges; jj unsorted unless
    `sort`."""
    rng = np.random.RandomState(seed)
    H2, W2 = H1 // 4, W1 // 4

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    g, f1, f2 = bf(E, P2, C), bf(F, H1, W1, C), bf(F, H2, W2, C)
    by1 = rng.randint(-14, H1 + 2, E)
    bx1 = 8 * rng.randint(-4, W1 // 8 + 1, E) + rng.randint(0, 2, E) * 4
    by2 = rng.randint(-12, H2 + 2, E)
    bx2 = rng.randint(-18, W2 + 2, E)
    by1[:4] = [1 - cp.WY, H1 - cp.WY, -cp.WY, H1 - 1]
    bx1[:4] = [1 - cp.WX, W1 - 8, W1, -cp.WX]
    by2[:4] = [1 - cp.WY2, H2 - 1, H2, -3]
    bx2[:4] = [-4, W2 - 1, -cp.WX2, W2]
    by1[4:6], bx1[4:6] = [-10 ** 6, 10 ** 6], [-10 ** 6, 10 ** 6]
    by2[4:6], bx2[4:6] = [10 ** 6, -10 ** 6], [10 ** 6, -10 ** 6]
    by1[11], bx1[11], by2[11], bx2[11] = 10, 16, 0, 2
    jj = rng.randint(0, F, E)
    if sort:
        jj = np.sort(jj)
    jj[7], jj[9] = -1, F
    return [a.astype(np.int32) if a.dtype.kind == 'i' else a
            for a in (g, f1, f2, jj, by1, bx1, by2, bx2)]


def _plain(g, f1, f2, jj, by1, bx1, by2, bx2):
    t = [torch.from_numpy(a) for a in (jj, by1, bx1, by2, bx2)]
    return cp.planes_pair_plain(torch.from_numpy(g).bfloat16(),
                                torch.from_numpy(f1).bfloat16(),
                                torch.from_numpy(f2).bfloat16(), *t)


def _assert_planes(got, ref):
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()      # every entry written, no NaN
    bound = 2 ** -7 * ref.abs() + 1e-5 * ref.abs().max()
    assert bool(((got - ref).abs() <= bound).all()), (got - ref).abs().max()
    assert bool((got[ref == 0] == 0).all())


# (seed, level-1 map, sorted jj, level-1 tile rows): maps whose level-2 map
# (H / 4) is below and above the level-2 tile (one row bin, several), a map
# smaller than the windows, sorted and unsorted frames, each level-1 tile
# of the sweep
DATAFLOW = [(0, (48, 80), False, 15), (1, (48, 80), True, 19),
            (2, (10, 12), False, 15), (3, (160, 48), False, 23),
            (4, (128, 40), True, 15)]


@pytest.mark.parametrize('seed,hw,sort,rows1', DATAFLOW,
                         ids=[f'{s}-{h}x{w}-{"sorted" if o else "unsorted"}'
                              f'-rows{r}' for s, (h, w), o, r in DATAFLOW])
def test_tile_dataflow_matches_plain(seed, hw, sort, rows1, monkeypatch):
    monkeypatch.setitem(cp.PAIR_TILE, 1, (rows1, *cp.PAIR_TILE[1][1:]))
    g, f1, f2, jj, by1, bx1, by2, bx2 = case = _case(
        seed, H1=hw[0], W1=hw[1], sort=sort)
    rng = np.random.RandomState(seed)
    ref = _plain(*case)
    work = bin_work(*[torch.from_numpy(a) for a in (jj, by1, bx1, by2, bx2)],
                    f1.shape[0], *f1.shape[1:3], *f2.shape[1:3])
    st = cp.tile_stats(work)
    copied = n_items = 0
    for level, fmap, by, bx, r in ((1, f1, by1, bx1, ref[0]),
                                   (2, f2, by2, bx2, ref[1])):
        got, items, _, c = _tile_chain(level, g, fmap, jj, by, bx, rng)
        _assert_planes(got, r)
        np.testing.assert_array_equal(items, work[level - 1].numpy())
        copied += c
        n_items += len(items)
        # the zero items: bad frames and windows that miss the map
        for e in (4, 5, 7, 9):
            assert not got[e].float().any()
    assert st['items'] == n_items and st['tile_bytes'] == copied * C * 2


@pytest.mark.parametrize('level', [1, 2])
@pytest.mark.parametrize('seed,hw', [(5, (48, 80)), (6, (160, 48)),
                                     (7, (10, 12))])
def test_binning_puts_every_edge_in_one_item(seed, hw, level):
    """The count, scan and scatter put each edge in exactly one item of
    its own bin, no item holds more than PAIR_CAP edges, a bin's items are
    consecutive and cover it, and the items are bin_items', in the same
    order."""
    g, f1, f2, jj, by1, bx1, by2, bx2 = _case(seed, E=300, H1=hw[0],
                                              W1=hw[1])
    fmap, by, bx = (f1, by1, bx1) if level == 1 else (f2, by2, bx2)
    F, H, W = fmap.shape[:3]
    nbins = pair_level(level, F, H, W)['ncoarse']
    items, rec = _bin_chain(pair_level(level, F, H, W), jj, by, bx,
                            np.random.RandomState(seed))
    bins = bin_keys(level, *[torch.from_numpy(a) for a in (jj, by, bx)], F,
                    H, W).numpy()
    seen = np.concatenate([rec[f:f + n, 0] for f, n, _, _ in items])
    assert sorted(seen) == list(range(len(jj)))
    assert (items[:, 1] >= 1).all() and (items[:, 1] <= cp.PAIR_CAP).all()
    for f, n, b, _ in items:
        assert (bins[rec[f:f + n, 0]] == b).all()
        assert (rec[f:f + n, 1] == by[rec[f:f + n, 0]]).all()
    assert (np.diff(items[:, 2]) >= 0).all()
    assert (items[1:, 0] == items[:-1, 0] + items[:-1, 1]).all()
    np.testing.assert_array_equal(
        items, bin_items(level, *[torch.from_numpy(a) for a in (jj, by, bx)],
                         F, H, W).numpy())
    assert items[-1, 2] == nbins - 1        # bad frames: the zero bin


def test_skewed_bin_splits_into_items():
    """Every edge at one base and frame: one bin of E edges, split into
    ceil(E / PAIR_CAP) items that spread over the grid, each still
    exact."""
    E = 3 * cp.PAIR_CAP + 5
    g, f1, f2, jj, by1, bx1, by2, bx2 = _case(8, E=E, F=2)
    jj[:], by1[:], bx1[:], by2[:], bx2[:] = 1, 5, 8, -2, -3
    rng = np.random.RandomState(8)
    ref = _plain(g, f1, f2, jj, by1, bx1, by2, bx2)
    for level, fmap, by, bx, r in ((1, f1, by1, bx1, ref[0]),
                                   (2, f2, by2, bx2, ref[1])):
        got, items, _, _ = _tile_chain(level, g, fmap, jj, by, bx, rng)
        assert [n for _, n, _, _ in items] == [cp.PAIR_CAP] * 3 + [5]
        assert len(set(items[:, 2])) == 1
        _assert_planes(got, r)


def test_out_of_range_frames_write_zeros():
    """Edges whose jj lies outside [0, F) all go to the zero bin at both
    levels, whose items copy no tile and write zeros."""
    g, f1, f2, jj, by1, bx1, by2, bx2 = _case(9, E=40)
    jj[::2] = np.where(np.arange(20) % 2, -5, 3)        # F = 3: out
    rng = np.random.RandomState(9)
    for level, fmap, by, bx in ((1, f1, by1, bx1), (2, f2, by2, bx2)):
        got, items, rec, _ = _tile_chain(level, g, fmap, jj, by, bx, rng)
        nbins = bin_plan(level, *fmap.shape[:3])[3]
        zero = np.concatenate([rec[f:f + n, 0] for f, n, b, _ in items
                               if b == nbins - 1])
        assert set(range(0, 40, 2)) <= set(zero)
        assert not got[::2].float().any()


def test_pair_constants_match_source():
    """The tiles, the cap and the g slots of csrc/corr_probes.cu are the
    wrapper's; its shared memory is pair_smem's; a tile holds a window and
    one producer lane copies each of its rows; the blocks fit an SM; the
    row bin rule is bin_plan's (level_shape with K4's tiles and cap)."""
    src = SRC.read_text()
    for level in (1, 2):
        m = re.search(r'struct PairTile<' + str(level) + r'> \{  // '
                      r'planes_pair level \d\s*static constexpr int kRows = '
                      r'(\d+), kWarps = (\d+), kBlocksPerSm = (\d+), '
                      r'kUnit = (\d+);', src)
        rows, warps, blocks, unit = map(int, m.groups())
        assert (rows, warps, blocks, unit) == cp.PAIR_TILE[level]
        wy, wx = WINS[level]
        assert wy <= rows <= 32
        pairs = wy * wx // 16
        assert pairs % unit == 0 and pairs // unit <= warps
        units = pairs // unit
        ng = cp.pair_gslots(level)
        assert ng >= 4 and ng * units % warps == 0
        smem = rows * wx * 256 + ng * (P2 * C * 2 + 16) + 16 + \
            8 * (2 + 2 * ng)
        assert smem == cp.pair_smem(level)
        assert (smem + 1024) * blocks <= 228 * 1024
        # a map of at most `rows` rows is one row bin; a taller one bins
        # rows - wy + 1 bases, so that a tile never passes `rows` rows
        assert bin_plan(level, 2, rows, 50)[:2] == (rows + wy - 1, 1)
        ty, nyb = bin_plan(level, 2, rows + 1, 50)[:2]
        assert ty + wy - 1 == rows and nyb == -(-(rows + wy) // ty)
    assert int(re.search(r'constexpr int kCap = (\d+);', src).group(1)) == \
        cp.PAIR_CAP
    assert 'std::max(4, T::kWarps / std::gcd(T::kWarps, kUnits));' in src
    assert 'b->TY = H <= R && !exact ? H + WY - 1 : R - WY + 1;' in src
    for level in (1, 2):
        assert (f'PairTile<{level}>::kRows, kCap, false)') in src
    # the tile of a bin (bin_rect), as _bin_chain and level_items take it;
    # K4's tile kernel takes the whole bin (fine rows 0 .. TY - 1)
    for line in ('t.bx = z - r * NXB - (WX - 1);',
                 'return (z / NXB % NYB) * TY - (WY - 1);',
                 't.y0 = max(t.ty0 + kf, 0);',
                 't.rows = min(t.ty0 + kl + WY, H) - t.y0;',
                 't.nx = min(t.bx + WX, W) - t.x0;', 'pos = t.rows * t.nx;'):
        assert line in src, line
    assert re.search(r'bin_rect\(item\.z, WY, WX, a\.TY, a\.NYB, a\.NXB, a\.H, '
                     r'a\.W, 0,\s+a\.TY - 1\);', src)


def _run_tile_block(items, warps, units, slots, rng):
    """One block of probe_pair_tiles driven only by its barriers, in a
    random interleaving of the producer and `warps` consumer warps: per
    item the producer waits for the tile's empty barrier (count `warps`,
    parity (n & 1) ^ 1), fills the tile (full, count 1), then per edge gi
    waits for g slot gi % slots to be released (count `units`, parity
    ((gi / slots) & 1) ^ 1) and fills it; a consumer waits for the tile
    (parity n & 1), then per edge, for its unit u = (w - gi * units) mod
    warps if u < units, waits for the slot (parity (gi / slots) & 1),
    reads it and releases it, and after the item releases the tile. A wait
    for parity p passes once the barrier's phase of parity p has completed.
    Fails on an overwrite of a slot or tile some owner has not read, a
    read of a stale one, or a deadlock. Returns the units each warp ran."""
    def barrier(count):
        return dict(count=count, n=0, done=0)

    def passes(bar, parity):
        return bar['done'] % 2 != parity

    def arrive(bar):
        bar['n'] += 1
        if bar['n'] == bar['count']:
            bar['n'], bar['done'] = 0, bar['done'] + 1

    full, empty = barrier(1), barrier(warps)
    gfull = [barrier(1) for _ in range(slots)]
    gempty = [barrier(units) for _ in range(slots)]
    tile, tile_readers = None, set()
    slot, slot_readers = [None] * slots, [set() for _ in range(slots)]
    prod, gi = [], 0
    for n, size in enumerate(items):
        prod.append(('tile', n, None))
        for _ in range(size):
            prod.append(('g', gi, n))
            gi += 1
    cons = []
    for w in range(warps):
        steps, gi = [], 0
        for n, size in enumerate(items):
            steps.append(('tile', n))
            for _ in range(size):
                u = (w - gi * units) % warps
                if u < units:
                    steps.append(('g', gi, u))
                gi += 1
            steps.append(('done', n))
        cons.append(steps)
    pi, ci = 0, [0] * warps
    ran = [[] for _ in range(warps)]
    while pi < len(prod) or any(ci[w] < len(cons[w]) for w in range(warps)):
        ready = []
        if pi < len(prod):
            kind, k, _ = prod[pi]
            if kind == 'tile':
                ok = passes(empty, (k & 1) ^ 1)
            else:
                ok = passes(gempty[k % slots], ((k // slots) & 1) ^ 1)
            if ok:
                ready.append(-1)
        for w in range(warps):
            if ci[w] < len(cons[w]):
                step = cons[w][ci[w]]
                if step[0] == 'tile':
                    ok = passes(full, step[1] & 1)
                elif step[0] == 'g':
                    ok = passes(gfull[step[1] % slots], (step[1] // slots) & 1)
                else:
                    ok = True
                if ok:
                    ready.append(w)
        assert ready, f'deadlock at producer step {pi}, consumers {ci}'
        w = ready[rng.randint(len(ready))]
        if w < 0:
            kind, k, n = prod[pi]
            if kind == 'tile':
                assert tile is None or len(tile_readers) == warps, \
                    'tile overwritten before every warp finished it'
                tile, tile_readers = k, set()
                arrive(full)
            else:
                s = k % slots
                assert slot[s] is None or len(slot_readers[s]) == units, \
                    f'g slot {s} overwritten before its owners read it'
                slot[s], slot_readers[s] = k, set()
                arrive(gfull[s])
            pi += 1
        else:
            step = cons[w][ci[w]]
            if step[0] == 'g':
                s = step[1] % slots
                assert slot[s] == step[1] and tile is not None
                slot_readers[s].add(w)
                arrive(gempty[s])
                ran[w].append((step[1], step[2]))
            elif step[0] == 'done':
                assert tile == step[1]
                tile_readers.add(w)
                arrive(empty)
            ci[w] += 1
    return ran


def _gslots(warps, units):
    """PairLevel::kGSlots for these warps and units per edge."""
    return max(4, warps // math.gcd(warps, units))


# (item sizes, consumer warps, units per edge): the kept tiles (level 1: 4
# warps, 2 units; level 2: 8 warps, 1 unit), the sweep's (4-8 warps, 1-3
# units), one-edge items, items past the slots, one warp
@pytest.mark.parametrize('sizes,warps,units', [
    ((5, 3, 7, 1, 9, 4), 4, 2), ((64, 17, 64, 2), 8, 1),
    ((1, 1, 1, 2, 1), 8, 1), ((6, 11, 3), 8, 2), ((9, 4, 12), 4, 3),
    ((13, 1, 8), 8, 3), ((5, 7), 1, 1), ((3, 20), 4, 4)])
def test_tile_barriers_run_each_unit_once(sizes, warps, units):
    """With the kernel's g slots, every unit of every edge runs once, on
    its warp, in edge order; no g slot or tile is overwritten before its
    readers are done, whatever the interleaving."""
    slots = _gslots(warps, units)
    rng = np.random.RandomState(sum(sizes) + warps)
    E = sum(sizes)
    for _ in range(3):
        ran = _run_tile_block(sizes, warps, units, slots, rng)
        got = sorted(x for r in ran for x in r)
        assert got == [(e, u) for e in range(E) for u in range(units)]
        for w, r in enumerate(ran):
            assert r == sorted(r)
            assert all((e * units + u) % warps == w for e, u in r)


def test_tile_barriers_need_owned_slots():
    """Why the slots are a multiple of warps / gcd(warps, units): with 8
    warps, one unit per edge and 4 slots, warp 7's first edge (7) reuses
    the slot of edge 3, whose phase warp 7 never waited for, so its wait
    can pass before edge 3's fill and read a stale slot."""
    rng = np.random.RandomState(0)
    with pytest.raises(AssertionError):
        for _ in range(20):
            _run_tile_block((64, 17, 64), 8, 1, 4, rng)


# ---- K6 slab (ops/corr_probes.py:slab) as target tiles over by-sorted edges

SLAB_N = cp.SLAB * cp.SLAB


def _slab_tiles(lv, g, fmap, items, rec):
    """probe_slab_tiles in numpy on the items and records of _bin_chain:
    per item its tile positions written back into `items`, the producer's
    copies (the in-map rows of its edges' windows
    into a tile poisoned with NaN, its edges' g rows into a flattened stage
    poisoned with NaN past them), the runs lo .. hi - 1 and units of its
    lanes (one per group of SLAB_TILE's unit rows, an inclusive scan of the
    units), then each unit found as the consumers find it (its group: the
    lanes whose units end at or before it; its near-equal share of the
    group's m16 tiles) and run: passes of at most SLAB_TILE's pass m16
    tiles of flattened g rows (stage rows clamped) times each row's 16
    positions (columns outside the map zeroed in the tile), k-step by
    k-step in f32, C rows past the unit dropped, a C row stored at each of
    the group's rows its edge's window holds, rows outside the map written
    as zero. Returns
    (out (E, 9, 256) f32, writes per entry, {'tile_bytes', 'g_bytes',
    'blocks' (m16 x n16 products run)})."""
    R, cap, _, _, K, unit, npass = cp.SLAB_TILE
    E = g.shape[0]
    out = np.full((E, P2, SLAB_N), np.nan, np.float32)
    writes = np.zeros((E, P2, SLAB_N), np.int64)
    ksteps = _kstep_channels()
    stats = dict(tile_bytes=0, g_bytes=0, blocks=0)
    for item in items:
        first, n, z, pos = item
        assert pos == 0                          # the scan left it
        recs = rec[first:first + n]
        if z == lv['ncoarse'] - 1:               # the zero bin
            out[recs[:, 0]] = 0.0
            writes[recs[:, 0]] += 1
            continue
        by_first, by_last = recs[0, 1], recs[-1, 1]
        ty0 = _bin_rect(lv, z, 0, 0)[1]
        bx, _, y0, rows, x0, nx = _bin_rect(lv, z, by_first - ty0,
                                            by_last - ty0)
        assert 0 < rows <= R and 0 < nx
        item[3] = rows * nx
        tile = np.full((R, cp.SLAB, C), np.nan, np.float32)
        tile[:rows] = 0.0                # the columns outside the map
        tile[:rows, x0 - bx:x0 - bx + nx] = fmap[y0:y0 + rows, x0:x0 + nx]
        stage = np.full((cap * P2, C), np.nan, np.float32)
        stage[:n * P2] = g[recs[:, 0]].reshape(-1, C)
        stats['tile_bytes'] += rows * nx * C * 2
        stats['g_bytes'] += n * P2 * C * 2
        assert (np.diff(recs[:, 1]) >= 0).all()          # sorted by by
        assert by_last + cp.SLAB - by_first <= R
        y = by_first + K * np.arange(32)           # the lanes' first rows
        lo = (recs[None, :, 1] < y[:, None] - (cp.SLAB - 1)).sum(1)
        hi = (recs[None, :, 1] <= y[:, None] + K - 1).sum(1)
        mt = -(-P2 * (hi - lo) // 16)
        units = np.where(y <= by_last + cp.SLAB - 1, -(-mt // unit), 0)
        uend = np.cumsum(units)
        for u in range(int(uend[-1])):
            j = int((uend[:R] <= u).sum())
            k, nu = u - (uend[j] - units[j]), units[j]
            assert 0 <= k < nu
            f = lo[j] * P2 + 16 * (k * mt[j] // nu)
            f_stop = min(lo[j] * P2 + 16 * ((k + 1) * mt[j] // nu),
                         hi[j] * P2)
            assert f_stop - f <= 16 * unit
            yj = by_first + K * j
            inside = [0 <= yj + r - y0 < rows for r in range(K)]
            B = [tile[yj + r - y0 if inside[r] else 0] for r in range(K)]
            while f < f_stop:
                m = min(npass, -(-(f_stop - f) // 16))
                fr = np.arange(f, f + 16 * m)
                A = stage[np.minimum(fr, cap * P2 - 1)]
                d = np.zeros((K, 16 * m, cp.SLAB), np.float32)
                for r in range(K):
                    for ch in ksteps:
                        d[r] += (A[:, ch] @ B[r][:, ch].T).astype(np.float32)
                stats['blocks'] += m * K
                for i in np.nonzero(fr < f_stop)[0]:
                    e, bye = recs[fr[i] // P2]
                    for r in range(K):
                        q = yj + r - bye
                        if 0 <= q < cp.SLAB:
                            c = slice(q * cp.SLAB, (q + 1) * cp.SLAB)
                            out[e, fr[i] % P2, c] = \
                                d[r, i] if inside[r] else 0.0
                            writes[e, fr[i] % P2, c] += 1
                f += 16 * m
    return out, writes, stats


def _slab_case(seed, E=160, H=40, W=56):
    """bf16-valued g and map; window bases across every border (negative,
    half and wholly outside, far outside), bx not a multiple of 8, and a
    third of the edges on a few shared windows (several edges per bin and
    by)."""
    rng = np.random.RandomState(seed)

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    g, fmap = bf(E, P2, C), bf(H, W, C)
    by = rng.randint(-20, H + 4, E)
    bx = rng.randint(-20, W + 4, E)
    shared = rng.randint(0, E, E // 3)
    by[shared] = rng.choice([-7, 0, 3, H - 9], len(shared))
    bx[shared] = rng.choice([-5, 8, 13, W - 16], len(shared))
    ext = [(-15, -15), (-16, 0), (0, -16), (H - 1, W - 1), (H, 0), (0, W),
           (-10 ** 6, 10 ** 6), (10 ** 6, -10 ** 6), (H - 8, -8), (-8, W - 8)]
    for e, (y, x) in enumerate(ext[:E]):
        by[e], bx[e] = y, x
    return g, fmap, by.astype(np.int32), bx.astype(np.int32)


def _slab_run(g, fmap, by, bx, seed):
    """The slab's chain in numpy (_bin_chain, _slab_tiles) against
    slab_plain and level_items; returns (items, rec, stats)."""
    H, W = fmap.shape[:2]
    lv = slab_level(H, W)
    items, rec = _bin_chain(lv, None, by, bx, np.random.RandomState(seed))
    out, writes, stats = _slab_tiles(lv, g, fmap, items, rec)
    assert (writes == 1).all()              # each entry written once
    ref = cp.slab_plain(torch.from_numpy(g).bfloat16(),
                        torch.from_numpy(fmap).bfloat16(),
                        torch.from_numpy(by), torch.from_numpy(bx))
    assert out.shape == tuple(ref.shape)
    if len(by):
        _assert_planes(torch.from_numpy(out).to(torch.bfloat16), ref)
    np.testing.assert_array_equal(
        items, slab_items(torch.from_numpy(by), torch.from_numpy(bx), H,
                          W).numpy().reshape(-1, 4))
    st = cp.tile_stats([torch.from_numpy(items)])
    assert st['tile_bytes'] == stats['tile_bytes']
    assert st['g_bytes'] == stats['g_bytes']
    return items, rec, stats


# (seed, map, SLAB_TILE): maps taller and wider than the tile, one smaller
# than the windows, and the sweep's tiles, caps, unit rows, units and
# passes
SLAB_DATAFLOW = [(0, (40, 56), None),
                 (1, (40, 56), (24, 16, 8, 1, 1, 4, 2)),
                 (2, (10, 12), None), (3, (30, 40), (32, 64, 8, 1, 2, 5, 4)),
                 (4, (72, 24), (20, 16, 4, 2, 1, 1, 1)),
                 (5, (40, 56), (32, 32, 8, 1, 1, 8, 3)),
                 (6, (33, 21), (19, 16, 8, 2, 2, 3, 2))]


@pytest.mark.parametrize('seed,hw,tile', SLAB_DATAFLOW,
                         ids=[f'{s}-{h}x{w}-{t}' for s, (h, w), t in
                              SLAB_DATAFLOW])
def test_slab_dataflow_matches_plain(seed, hw, tile, monkeypatch):
    if tile is not None:
        monkeypatch.setattr(cp, 'SLAB_TILE', tile)
    _slab_run(*_slab_case(seed, H=hw[0], W=hw[1]), seed)


@pytest.mark.parametrize('E', [0, 1, cp.SLAB_TILE[1] - 1, cp.SLAB_TILE[1],
                               cp.SLAB_TILE[1] + 1])
def test_slab_edge_counts(E):
    """No edge, one, and one below, at and above the cap, every edge on
    one window: ceil(E / cap) items of that window's bin."""
    cap = cp.SLAB_TILE[1]
    g, fmap, by, bx = _slab_case(10 + E, E=max(E, 1))
    g, by, bx = g[:E], np.full(E, 5, np.int32), np.full(E, -3, np.int32)
    items, _, stats = _slab_run(g, fmap, by, bx, E)
    assert [int(n) for n in items[:, 1]] == \
        [min(cap, E - k) for k in range(0, E, cap)]
    assert len(set(items[:, 2])) <= 1
    # one window: each of its 16 rows' runs holds every edge of the item
    assert stats['blocks'] == sum(cp.SLAB * -(-P2 * int(n) // 16)
                                  for n in items[:, 1])


def test_slab_skewed_bin_splits_into_items():
    """Every edge in one coarse bin, by spread over its row bin: the bin
    splits into items of cap edges, each sorted by by, each tile only the
    rows of its own edges' windows."""
    cap = cp.SLAB_TILE[1]
    E = 3 * cap + 5
    g, fmap, by, bx = _slab_case(11, E=E, H=60)
    ty = slab_level(60, 56)['TY']
    by[:] = ty - 15 + np.random.RandomState(11).randint(0, ty, E)
    bx[:] = 9
    items, rec, _ = _slab_run(g, fmap, by, bx, 11)
    assert [int(n) for n in items[:, 1]] == [cap] * 3 + [5]
    assert len(set(items[:, 2])) == 1
    for first, n, _, pos in items:
        ys = rec[first:first + n, 1]
        assert pos == (min(ys[-1] + cp.SLAB, 60) - max(ys[0], 0)) * cp.SLAB


@pytest.mark.parametrize('seed,hw', [(12, (40, 56)), (13, (120, 160)),
                                     (14, (10, 12))])
def test_slab_binning_properties(seed, hw):
    """Each edge in exactly one item of at most the cap; one bx per item;
    by sorted within an item; an item's windows span at most the tile's
    rows; each edge's 16 window rows in the runs of its item's rows once;
    the zero bin holds exactly the edges whose windows miss the map."""
    H, W = hw
    g, fmap, by, bx = _slab_case(seed, E=400, H=H, W=W)
    lv = slab_level(H, W)
    items, rec = _bin_chain(lv, None, by, bx, np.random.RandomState(seed))
    R, cap = cp.SLAB_TILE[:2]
    seen = np.concatenate([rec[f:f + n, 0] for f, n, _, _ in items])
    assert sorted(seen) == list(range(len(by)))
    assert ((items[:, 1] >= 1) & (items[:, 1] <= cap)).all()
    miss = (by <= -cp.SLAB) | (by >= H) | (bx <= -cp.SLAB) | (bx >= W)
    for f, n, z, _ in items:
        e, ys = rec[f:f + n, 0], rec[f:f + n, 1]
        assert (ys == by[e]).all()
        if z == lv['ncoarse'] - 1:
            assert miss[e].all()
            continue
        assert (np.diff(ys) >= 0).all()
        assert not miss[e].any() and len(set(bx[e])) == 1
        assert ys[-1] + cp.SLAB - ys[0] <= R
        cover = np.zeros(n, np.int64)
        for y in range(ys[0], ys[-1] + cp.SLAB):
            lo = int((ys < y - (cp.SLAB - 1)).sum())
            hi = int((ys <= y).sum())
            cover[lo:hi] += 1
        assert (cover == cp.SLAB).all()
    assert int(sum(items[items[:, 2] == lv['ncoarse'] - 1, 1])) == miss.sum()


def test_slab_constants_match_source():
    """SlabTile of csrc/corr_probes.cu is SLAB_TILE; its shared memory is
    slab_smem's; the blocks fit an SM; the slab's level is level_shape
    with its rows and cap and exact-by fine bins (slab_level); its scratch
    layout is bin_plan's."""
    src = SRC.read_text()
    m = re.search(r'struct SlabTile \{  // slab\s*static constexpr int '
                  r'kRows = (\d+), kCap = (\d+), kWarps = (\d+), '
                  r'kBlocksPerSm = (\d+),\s*kUnitRows = (\d+), kUnit = '
                  r'(\d+), kPass = (\d+);', src)
    tile = tuple(map(int, m.groups()))
    assert tile == cp.SLAB_TILE
    rows, cap, warps, blocks, unit_rows, unit, npass = tile
    assert cp.SLAB < rows <= 32 and 2 <= cap <= 64 and cap % 2 == 0
    assert 1 <= unit_rows <= 2 and 1 <= npass <= min(4, unit)
    smem = rows * 16 * 256 + cap * P2 * 256 + 8 * cap + 16 * rows + 64
    assert smem == cp.slab_smem()
    assert (smem + 1024) * blocks <= 228 * 1024
    assert ('level_shape(&L->l[0], 1, H, W, kSlab, kSlab, SlabTile::kRows,\n'
            '                  SlabTile::kCap, true)') in src
    assert "b->G = exact ? b->TY : 1;" in src
    assert 'constexpr int kMaxFine = 17;' in src and rows - 15 <= 17
    # bin_plan's layout: every level's fine-bin counts, then per level
    # items [4E], rec [2E], part [2 nblocks], key [E], off [nbins], nitems,
    # claim, padded to 16 bytes
    for line in ('x.rec = reinterpret_cast<int2*>(scratch + at + 4ll * E);',
                 'x.part = reinterpret_cast<int2*>(scratch + at + 6ll * E);',
                 'x.key = scratch + at + 6ll * E + 2ll * x.nblocks;',
                 'x.nitems_at = at + 6ll * E + 2ll * x.nblocks + E + nb[l];',
                 'at += round4(7ll * E + 2ll * x.nblocks + nb[l] + 2);'):
        assert line in src, line
    # row bins of rows - 15 exact-by fine bins, however small the map, so
    # that an item's windows span at most `rows` rows
    for h in (5, rows, rows + 1, 120):
        lv = slab_level(h, 50)
        assert lv['TY'] == lv['G'] == rows - 15
        assert lv['NYB'] == -(-(h + 15) // (rows - 15))


def test_slab_store_quad_gathers_a_row():
    """slab_pass's stores: lane t of a quad holds columns 2t, 2t + 1 of
    each n8 tile (av: tile 0, bv: tile 1); after the two xor shuffles
    (by 2, then by 1) it stores columns 4t .. 4t + 3 in order, so that the
    quad writes the row's 16 columns as one 32-byte sector."""
    src = SRC.read_text()
    for line in ('const uint32_t keep = t < 2 ? av : bv;',
                 '__shfl_xor_sync(0xffffffffu, t < 2 ? bv : av, 2);',
                 'const uint32_t lo = t < 2 ? keep : got, hi = t < 2 ? got '
                 ': keep;',
                 '__shfl_xor_sync(0xffffffffu, t & 1 ? lo : hi, 1);',
                 't & 1 ? make_uint2(x, hi) : make_uint2(lo, x);',
                 'bf16* o = out + (static_cast<size_t>(eb.x) * kP2 + p) * '
                 'kSlabN + 4 * t;'):
        assert line in src, line
    av = [(2 * t, 2 * t + 1) for t in range(4)]        # column pairs
    bv = [(8 + 2 * t, 9 + 2 * t) for t in range(4)]
    keep = [av[t] if t < 2 else bv[t] for t in range(4)]
    send = [bv[t] if t < 2 else av[t] for t in range(4)]
    got = [send[t ^ 2] for t in range(4)]
    lo = [keep[t] if t < 2 else got[t] for t in range(4)]
    hi = [got[t] if t < 2 else keep[t] for t in range(4)]
    send = [lo[t] if t & 1 else hi[t] for t in range(4)]
    x = [send[t ^ 1] for t in range(4)]
    stored = [(x[t], hi[t]) if t & 1 else (lo[t], x[t]) for t in range(4)]
    for t in range(4):
        assert [c for pair in stored[t] for c in pair] == \
            list(range(4 * t, 4 * t + 4))
