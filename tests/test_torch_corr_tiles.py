"""K4 (ops/corr_probes.py:planes_pair) as target tiles on the CPU: the
chain of csrc/corr_probes.cu (pair_bin_count, pair_bin_sums, pair_bin_scan,
pair_bin_scatter, probe_pair_tiles<1>, <2>) emulated in numpy step by step
against the plain planes (planes_pair_plain) and against a vectorised
emulation of the binning (bin_plan, bin_keys, bin_items, bin_tiles; the
card's tests hold the items that the chain reads back, corr_probes.
pair_work, against bin_items), and its constants read from the source.

The emulation follows the kernels:
  * the count: each edge's bin at each level, (frame, (by + WY - 1) // TY,
    bx + WX - 1), or the last bin for an edge whose frame is out of range
    or whose window misses the map; the bins' counts;
  * the scan: blocks of 1024 consecutive bins, one thread each; the sums
    of each block's edges and items (pair_bin_sums), then per block the
    sums of the blocks before it plus the block's exclusive scans
    (pair_bin_scan), a bin of n edges giving ceil(n / 64) items (first
    position, edges, bin, the positions of the bin's tile in the map);
  * the scatter: the edges in any order (atomics), each to its bin's next
    position as (edge, by);
  * the tile kernel: per item the in-map rows of its tile copied into a
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


def bin_plan(level, F, H, W):
    """K4's binning of `level` (csrc/corr_probes.cu:pair_bins_shape): the
    window bases per row bin TY (a map of at most the tile's rows is one
    bin, else tile rows - WY + 1 bases), the row bins NYB, the column keys
    NXB (one per base bx whose window meets the map) and the bins, the
    last of which holds the edges that write zeros. (TY, NYB, NXB,
    nbins)."""
    wy, wx = WINS[level]
    rows = cp.PAIR_TILE[level][0]
    ty = H + wy - 1 if H <= rows else rows - wy + 1
    nyb = -(-(H + wy - 1) // ty)
    return ty, nyb, W + wx - 1, F * nyb * (W + wx - 1) + 1


def bin_keys(level, jj, by, bx, F, H, W):
    """(E,) int64: each edge's bin at `level` (bin_plan), (frame, (by + WY
    - 1) // TY, bx + WX - 1) in row-major order; an edge whose frame is
    out of range or whose window misses the map takes the last bin."""
    wy, wx = WINS[level]
    ty, nyb, nxb, nbins = bin_plan(level, F, H, W)
    jj, by, bx = jj.long(), by.long(), bx.long()
    live = ((jj >= 0) & (jj < F) & (by > -wy) & (by < H) & (bx > -wx) &
            (bx < W))
    key = (jj * nyb + torch.div(by + wy - 1, ty, rounding_mode='floor')) \
        * nxb + bx + wx - 1
    return torch.where(live, key, nbins - 1)


def bin_tiles(level, bins, F, H, W):
    """The positions in the map of the tiles of bins `bins` (pair_rect's
    rows x nx), (n,) int64; 0 for the bin that writes zeros."""
    wy, wx = WINS[level]
    ty, nyb, nxb, nbins = bin_plan(level, F, H, W)
    r = torch.div(bins, nxb, rounding_mode='floor')
    bx = bins - r * nxb - (wx - 1)
    ty0 = torch.remainder(r, nyb) * ty - (wy - 1)
    rows = torch.clamp(ty0 + ty + wy - 1, max=H) - ty0.clamp(min=0)
    nx = torch.clamp(bx + wx, max=W) - bx.clamp(min=0)
    return torch.where(bins == nbins - 1, 0, rows * nx)


def bin_items(level, jj, by, bx, F, H, W):
    """K4's work items at `level`, in the kernel's order (by bin; a bin of
    n edges is ceil(n / PAIR_CAP) items): (items, 4) int64 rows (first
    position in the edges sorted by bin, edges, bin, tile positions), as
    pair_work reads them back."""
    nbins = bin_plan(level, F, H, W)[3]
    count = torch.bincount(bin_keys(level, jj, by, bx, F, H, W),
                           minlength=nbins)
    start = torch.cumsum(count, 0) - count
    per = -(-count // cp.PAIR_CAP)
    b = torch.repeat_interleave(torch.arange(nbins, device=count.device),
                                per)
    k = torch.arange(len(b), device=b.device) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    return torch.stack([start[b] + k * cp.PAIR_CAP,
                        torch.clamp(count[b] - k * cp.PAIR_CAP,
                                    max=cp.PAIR_CAP), b,
                        bin_tiles(level, b, F, H, W)], 1)


def bin_work(jj, by1, bx1, by2, bx2, F, H1, W1, H2, W2):
    """Both levels' bin_items, as pair_work returns them."""
    return [bin_items(1, jj, by1, bx1, F, H1, W1),
            bin_items(2, jj, by2, bx2, F, H2, W2)]


def _bin_chain(level, jj, by, bx, F, H, W, rng):
    """pair_bin_count, pair_bin_sums, pair_bin_scan and pair_bin_scatter
    at `level` in numpy. Returns (items as (n, 4) int64 rows (first, edges,
    bin, tile positions), rec (E, 2) int64 rows (edge, by) in bin order,
    the plan)."""
    wy, wx = WINS[level]
    ty, nyb, nxb, nbins = bin_plan(level, F, H, W)
    E = len(jj)
    key = np.empty(E, np.int64)
    count = np.zeros(nbins, np.int64)
    for e in range(E):
        live = (0 <= jj[e] < F and -wy < by[e] < H and -wx < bx[e] < W)
        key[e] = ((jj[e] * nyb + (by[e] + wy - 1) // ty) * nxb + bx[e] +
                  wx - 1) if live else nbins - 1
        count[key[e]] += 1
    nblocks = -(-nbins // SCAN_THREADS)
    per_bin = -(-count // cp.PAIR_CAP)
    part = [(int(count[k * SCAN_THREADS:(k + 1) * SCAN_THREADS].sum()),
             int(per_bin[k * SCAN_THREADS:(k + 1) * SCAN_THREADS].sum()))
            for k in range(nblocks)]                       # pair_bin_sums
    off = np.zeros(nbins, np.int64)
    items = np.zeros((int(per_bin.sum()), 4), np.int64)
    for k in range(nblocks):                               # pair_bin_scan
        e0 = sum(q[0] for q in part[:k])
        i0 = sum(q[1] for q in part[:k])
        lo, hi = k * SCAN_THREADS, min(nbins, (k + 1) * SCAN_THREADS)
        for i in range(lo, hi):    # the block's exclusive scans, thread i
            eo = e0 + int(count[lo:i].sum())
            io = i0 + int(per_bin[lo:i].sum())
            off[i] = eo
            pos = 0                          # pair_rect's rows x nx
            if count[i] and i != nbins - 1:
                r = i // nxb
                bx0, ty0 = i - r * nxb - (wx - 1), (r % nyb) * ty - (wy - 1)
                pos = (min(ty0 + ty + wy - 1, H) - max(ty0, 0)) * \
                    (min(bx0 + wx, W) - max(bx0, 0))
            for m in range(0, count[i], cp.PAIR_CAP):
                items[io] = (eo + m, min(cp.PAIR_CAP, count[i] - m), i, pos)
                io += 1
    rec = np.zeros((E, 2), np.int64)
    for e in rng.permutation(E):                 # atomics: any order
        rec[off[key[e]]] = (e, by[e])
        off[key[e]] += 1
    return items, rec, (ty, nyb, nxb, nbins)


def _tile_chain(level, g, fmap, jj, by, bx, rng):
    """The whole chain at `level` in numpy: (planes (E, 9, WY * WX) bf16,
    items, rec, tile bytes copied)."""
    wy, wx = WINS[level]
    F, H, W = fmap.shape[:3]
    R = cp.PAIR_TILE[level][0]
    N, tpr = wy * wx, wx // 8
    items, rec, (ty, nyb, nxb, nbins) = _bin_chain(level, jj, by, bx, F, H,
                                                   W, rng)
    E = len(jj)
    out = np.full((E, P2, N), np.nan, np.float32)
    ksteps = _kstep_channels()
    copied = 0
    for first, n, b, pos in items:
        tiled = b != nbins - 1
        tile = np.full((R, wx, C), np.nan, np.float32)   # stale bytes
        y0 = bx0 = 0
        if tiled:                        # the producer's decode and copies
            r = b // nxb
            bx0 = b - r * nxb - (wx - 1)
            ty0 = (r % nyb) * ty - (wy - 1)
            j = r // nyb
            y0 = max(ty0, 0)
            rows = min(ty0 + ty + wy - 1, H) - y0
            x0, nx = max(bx0, 0), min(bx0 + wx, W) - max(bx0, 0)
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
    st = cp.pair_stats(work)
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
    items, rec, (_, _, _, nbins) = _bin_chain(
        level, jj, by, bx, F, H, W, np.random.RandomState(seed))
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
    row bin rule is bin_plan's."""
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
    assert re.search(r'\*TY = H <= R \? H \+ P::kWY - 1 : R - P::kWY \+ 1;',
                     src)
    # the tile of a bin (pair_rect), as _bin_chain and bin_tiles take it
    for line in ('t.bx = z - r * NXB - (WX - 1);',
                 't.ty0 = (r % NYB) * TY - (WY - 1);',
                 't.rows = min(t.ty0 + TY + WY - 1, H) - t.y0;',
                 't.nx = min(t.bx + WX, W) - t.x0;', 'pos = t.rows * t.nx;'):
        assert line in src, line


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
