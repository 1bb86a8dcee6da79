"""K2's kernel for bf16 maps (csrc/corr_fused.cu:corr_planes_ring), on the
CPU: its dataflow emulated in numpy against the plain planes
(ops/corr_fused.py:planes_plain), its constants read from the source, and
its ring's barrier-parity protocol run in random interleavings.

The emulation follows the kernel step by step: per edge its window bases
(far above the map for an edge whose kk or jj is out of range), per
producer lane r its window row's in-map run of positions, per stage of
RING_ROWS positions the part of each lane's run that falls in it (one bulk
copy; every other slot keeps the stale row of an earlier stage, poisoned
with NaN here, as is the g slot of an edge that copies none), the mma dot with the channels permuted identically in A and
B (f32 sums of bf16 inputs, one per k-step of 16 channels), and the
epilogue that writes columns outside the map as zero, trades columns
within each quad of lanes so that a warp stores a pair of tiles 16
columns at a time, and rounds to bf16.
Bound against the plain version: one bf16 rounding of the same f32 sums in
another order, 2^-7 |plain| + 1e-5 max|plain|; entries outside the map
exactly zero."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_fused as cf

SRC = Path(cf.__file__).resolve().parent.parent / 'csrc' / 'corr_fused.cu'
C, P2 = cf.C, cf.P2
N1, N2 = cf.WY * cf.WX, cf.WY2 * cf.WX2
FAR = -(1 << 28)


def _row_run(r, base, H1, W1, H2, W2):
    """The kernel's row_run: window row r of an edge (r < 12 at level 1,
    then level 2) as (qa, qb, y, x0, level 2?): its positions [qa, qb)
    whose pixels lie in the map, from map pixel (y, x0) on; qa == qb for
    none (and for the producer lanes r >= 22, which own no row)."""
    l2 = r >= cf.WY
    wy, wx = (r - cf.WY, cf.WX2) if l2 else (r, cf.WX)
    y = (base[2] if l2 else base[0]) + wy
    bx = base[3] if l2 else base[1]
    W = W2 if l2 else W1
    x0, x1 = max(bx, 0), min(bx + wx, W)
    if r >= cf.WY + cf.WY2 or not 0 <= y < (H2 if l2 else H1) or x0 >= x1:
        return 0, 0, 0, 0, l2
    q0 = (N1 if l2 else 0) + wy * wx - bx
    return q0 + x0, q0 + x1, y, x0, l2


def _stage_copies(c, base, H1, W1, H2, W2):
    """The bulk copies of stage c (positions [c * Q, c * Q + Q)), one per
    producer lane whose row's run meets it: (q, y, x, count, level 2?)."""
    Q = cf.RING_ROWS
    out = []
    for lane in range(32):
        qa, qb, y, x0, l2 = _row_run(lane, base, H1, W1, H2, W2)
        lo = max(qa, c * Q)
        n = min(qb, c * Q + Q) - lo
        if n > 0:
            out.append((lo, y, x0 + lo - qa, n, l2))
    return out


def _kstep_channels():
    """The channels of each mma k-step (mma_bf16.cuh): chunk c, half h
    takes 32c + 8t + 4h + {0, 1, 2, 3} for lane column t = 0 .. 3."""
    return [np.array([32 * c + 8 * t + 4 * h + i for t in range(4)
                      for i in range(4)]) for c in range(4) for h in range(2)]


def _pair_cols():
    """store_planes_pair's shuffles: in a quad, lane s holds columns 2s,
    2s + 1 of each tile of the pair; lane t stores columns 4t .. 4t + 3 of
    the pair's 16, taken from lanes s0 = 2t mod 4 and s0 + 1 of the first
    tile (t < 2) or the second. Returns, for each stored column, the
    column of the pair it holds."""
    cols = []
    for t in range(4):
        s0 = (2 * t) & 3
        tile = 0 if t < 2 else 8
        cols += [tile + 2 * s + i for s in (s0, s0 + 1) for i in (0, 1)]
    return np.array(cols)


_PAIR_COLS = _pair_cols()


def _emulate(g, f1, f2, kk, jj, by1, bx1, by2, bx2):
    """corr_planes_ring's dataflow in numpy (module docstring). Returns the
    planes (E, 9, 12, 24), (E, 9, 10, 16) as bf16 tensors and the window
    rows copied per edge."""
    E, Ng, F = len(kk), g.shape[0], f1.shape[0]
    H1, W1, H2, W2 = f1.shape[1], f1.shape[2], f2.shape[1], f2.shape[2]
    Q = cf.RING_ROWS
    out = np.zeros((E, P2, N1 + N2), np.float32)
    copied = np.zeros(E, np.int64)
    ksteps = _kstep_channels()
    stale = np.full((Q, C), np.nan, np.float32)
    for e in range(E):
        ok = 0 <= kk[e] < Ng and 0 <= jj[e] < F
        base = (by1[e], bx1[e], by2[e], bx2[e]) if ok else (FAR, 0, FAR, 0)
        a = np.zeros((16, C), np.float32)          # rows 9-15 zero
        a[:P2] = g[kk[e]] if ok else np.nan        # no copy: a stale slot
        for c in range((N1 + N2) // Q):
            stage = stale.copy()
            for q, y, x, n, l2 in _stage_copies(c, base, H1, W1, H2, W2):
                frame = (f2 if l2 else f1)[jj[e]]
                stage[q - c * Q:q - c * Q + n] = frame[y, x:x + n]
                copied[e] += n
            d = np.zeros((16, Q), np.float32)
            for ch in ksteps:
                d += (a[:, ch] @ stage[:, ch].T).astype(np.float32)
            masked = np.zeros((P2, Q), np.float32)
            for t in range(Q // 8):                # the epilogue's masks
                tq = c * Q // 8 + t
                l2 = tq >= N1 // 8
                tl = tq - N1 // 8 if l2 else tq
                tpr = (cf.WX2 if l2 else cf.WX) // 8
                y = (base[2] if l2 else base[0]) + tl // tpr
                x = (base[3] if l2 else base[1]) + (tl % tpr) * 8 + \
                    np.arange(8)
                H, W = (H2, W2) if l2 else (H1, W1)
                inside = (0 <= y < H) & (x >= 0) & (x < W)
                masked[:, t * 8:t * 8 + 8] = np.where(
                    inside, d[:P2, t * 8:t * 8 + 8], 0.0)
            for t in range(0, Q // 8, 2):          # a warp's tile pair
                pair = masked[:, t * 8:t * 8 + 16]
                col = c * Q + t * 8                # edge position of tile t
                out[e, :, col:col + 16] = pair[:, _PAIR_COLS]
    planes = torch.from_numpy(out).to(torch.bfloat16)
    return (planes[..., :N1].reshape(E, P2, cf.WY, cf.WX),
            planes[..., N1:].reshape(E, P2, cf.WY2, cf.WX2), copied)


def _case(seed, E=60, F=3, Ng=8, H1=48, W1=80):
    """bf16-valued g and maps, and window bases at all four borders, far
    outside (past window_base's clamp, at both ends), negative bx, wholly
    inside; kk / jj out of range (-1, Ng, F) on a few edges."""
    rng = np.random.RandomState(seed)
    H2, W2 = H1 // 4, W1 // 4

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    g, f1, f2 = bf(Ng, P2, C), bf(F, H1, W1, C), bf(F, H2, W2, C)
    by1 = rng.randint(-14, H1 + 2, E)
    bx1 = 8 * rng.randint(-4, W1 // 8 + 1, E)
    by2 = rng.randint(-12, H2 + 2, E)
    bx2 = 4 * rng.randint(-5, W2 // 4 + 1, E)
    # the four borders, exactly and one past
    by1[:4], bx1[:4] = [-11, H1 - 12, 0, H1 - 1], [0, 8, -24, W1 - 8]
    by2[:4], bx2[:4] = [-9, H2 - 10, 0, H2 - 1], [-16, W2 - 16, 0, W2 - 4]
    by1[4:6], bx1[4:6] = [-10 ** 6, 10 ** 6], [-10 ** 6, 10 ** 6]  # far
    by2[4:6], bx2[4:6] = [10 ** 6, -10 ** 6], [10 ** 6, -10 ** 6]
    by1[11], bx1[11], by2[11], bx2[11] = 10, 16, 1, 2       # inside
    kk = rng.randint(0, Ng, E)
    jj = np.sort(rng.randint(0, F, E))
    kk[6], jj[7], kk[8], jj[9], kk[10], jj[10] = -1, -1, Ng, F, Ng + 5, -3
    return [a.astype(np.int32) if a.dtype.kind == 'i' else a
            for a in (g, f1, f2, kk, jj, by1, bx1, by2, bx2)]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ring_dataflow_matches_plain(seed):
    args = _case(seed)
    g, f1, f2, kk, jj, by1, bx1, by2, bx2 = args
    t = [torch.from_numpy(a) for a in args]
    ref = cf.planes_plain(t[0].to(torch.bfloat16), t[1].to(torch.bfloat16),
                          t[2].to(torch.bfloat16), *t[3:])
    p1, p2, copied = _emulate(*args)
    for got, r in zip((p1, p2), ref):
        got, r = got.float(), r.float()
        assert torch.isfinite(got).all()     # no stale row leaks a NaN
        bound = 2 ** -7 * r.abs() + 1e-5 * r.abs().max()
        assert bool(((got - r).abs() <= bound).all()), \
            (got - r).abs().max()
        assert bool((got[r == 0] == 0).all())
    rows = cf.window_rows(*t[3:], g.shape[0], f1.shape[0], *f1.shape[1:3],
                          *f2.shape[1:3])
    np.testing.assert_array_equal(copied, rows.numpy())
    # the case reaches every branch: partial rows, edges copying nothing,
    # edges copying their whole windows, zero planes for bad kk / jj
    assert (copied == 0).any() and (copied == N1 + N2).any()
    assert ((copied > 0) & (copied < N1 + N2)).any()
    for e in (6, 7, 8, 9, 10):
        assert not p1[e].float().any() and not p2[e].float().any()


def test_copies_cover_in_map_positions():
    """The producer lanes' bulk copies, over the stages of an edge, copy
    exactly the in-map positions of both windows, each once, into the stage
    slot of their position."""
    rng = np.random.RandomState(3)
    H1, W1, H2, W2 = 17, 29, 5, 7
    for _ in range(200):
        base = (rng.randint(-14, H1 + 2), rng.randint(-30, W1 + 2),
                rng.randint(-12, H2 + 2), rng.randint(-18, W2 + 2))
        seen = []
        for c in range((N1 + N2) // cf.RING_ROWS):
            for q, y, x, n, l2 in _stage_copies(c, base, H1, W1, H2, W2):
                assert c * cf.RING_ROWS <= q and \
                    q + n <= (c + 1) * cf.RING_ROWS
                seen += [(q + i, y, x + i, l2) for i in range(n)]
        want = []
        for q in range(N1 + N2):
            l2 = q >= N1
            qq, wx = (q - N1, cf.WX2) if l2 else (q, cf.WX)
            y = (base[2] if l2 else base[0]) + qq // wx
            x = (base[3] if l2 else base[1]) + qq % wx
            if 0 <= y < (H2 if l2 else H1) and 0 <= x < (W2 if l2 else W1):
                want.append((q, y, x, l2))
        assert seen == want


def _source_consts():
    src = SRC.read_text()
    consts = {}
    for name, val in re.findall(r'\b(k\w+) = (-?\d+)[,;]', src):
        consts.setdefault(name, int(val))
    ring = re.search(r'struct PlanesRing \{\s*static constexpr int '
                     r'kStages = (\d+), kRows = (\d+), kWarps = (\d+), '
                     r'kBlocksPerSm = (\d+);', src)
    return consts, tuple(int(v) for v in ring.groups())


def test_constants_match_kernel_source():
    consts, (stages, rows, warps, blocks) = _source_consts()
    assert (consts['kWY1'], consts['kWX1']) == (cf.WY, cf.WX)
    assert (consts['kWY2'], consts['kWX2']) == (cf.WY2, cf.WX2)
    assert (stages, rows, warps) == (cf.RING_STAGES, cf.RING_ROWS,
                                     cf.RING_WARPS)
    assert (N1 + N2) % rows == 0 and rows % 8 == 0
    smem = stages * rows * C * 2 + 2 * (P2 * C * 2 + 16) + 8 * (2 * stages
                                                              + 4)
    assert smem == cf.ring_smem()
    # the blocks asked for fit an SM's 228 KB, 1 KB reserved per block
    assert (smem + 1024) * blocks <= 228 * 1024


def ring_schedule(E, grid, chunks):
    """corr_planes_ring's order of work (csrc/corr_fused.cu): block b takes
    edges b, b + grid, ...; per edge one g-slot fill, then `chunks` stage
    fills. Returns, per block, the list of its edges."""
    return [list(range(b, E, grid)) for b in range(min(grid, E))]


def _run_block(edges, chunks, stages, warps, rng):
    """One block of the ring, driven only by the kernel's parity waits: one
    producer and `warps` consumer warps stepping in a random interleaving.
    A wait for parity p passes once the barrier's phase of parity p has
    completed (its count of completed phases odd for p = 0, even for
    p = 1). The producer's k-th stage fill goes to stage k % stages and
    waits on that stage's empty barrier for parity ((k / stages) & 1) ^ 1;
    a consumer waits on its full barrier for parity (k / stages) & 1; the
    i-th edge's g slot i % 2 the same with parity (i / 2) & 1. Fails on an
    overwrite of a stage or slot some warp has not read, a read of a stale
    one, or a deadlock. Returns each warp's reads in order."""
    def passes(bar, parity):
        return bar['done'] % 2 != parity

    def arrive(bar):
        bar['n'] += 1
        if bar['n'] == bar['count']:
            bar['n'] = 0
            bar['done'] += 1

    def barrier(count):
        return dict(count=count, n=0, done=0)

    full = [barrier(1) for _ in range(stages)]
    empty = [barrier(warps) for _ in range(stages)]
    gfull = [barrier(1) for _ in range(2)]
    gempty = [barrier(warps) for _ in range(2)]
    stage = [None] * stages
    readers = [set() for _ in range(stages)]
    slot = [None, None]
    slot_readers = [set(), set()]

    # the producer's steps: ('g', i, e) then ('c', k, (e, c)) per chunk
    prod = []
    k = 0
    for i, e in enumerate(edges):
        prod.append(('g', i, e))
        for c in range(chunks):
            prod.append(('c', k, (e, c)))
            k += 1
    cons = [list(prod) for _ in range(warps)]
    pi, ci = 0, [0] * warps
    reads = [[] for _ in range(warps)]
    while pi < len(prod) or any(ci[w] < len(cons[w]) for w in range(warps)):
        ready = []
        if pi < len(prod):
            kind, n, what = prod[pi]
            if kind == 'g':
                ok = passes(gempty[n % 2], ((n >> 1) & 1) ^ 1)
            else:
                ok = passes(empty[n % stages], ((n // stages) & 1) ^ 1)
            if ok:
                ready.append(-1)
        for w in range(warps):
            if ci[w] < len(cons[w]):
                kind, n, what = cons[w][ci[w]]
                bar = gfull[n % 2] if kind == 'g' else full[n % stages]
                par = (n >> 1) & 1 if kind == 'g' else (n // stages) & 1
                if passes(bar, par):
                    ready.append(w)
        assert ready, f'deadlock at producer step {pi}, consumers {ci}'
        w = ready[rng.randint(len(ready))]
        if w < 0:
            kind, n, what = prod[pi]
            if kind == 'g':
                s = n % 2
                assert slot[s] is None or len(slot_readers[s]) == warps, \
                    f'g slot {s} overwritten before every warp read it'
                slot[s], slot_readers[s] = what, set()
                arrive(gfull[s])
            else:
                s = n % stages
                assert stage[s] is None or len(readers[s]) == warps, \
                    f'stage {s} overwritten before every warp read it'
                stage[s], readers[s] = what, set()
                arrive(full[s])
            pi += 1
        else:
            kind, n, what = cons[w][ci[w]]
            if kind == 'g':
                s = n % 2
                assert slot[s] == what, f'g slot {s} holds {slot[s]}'
                slot_readers[s].add(w)
                arrive(gempty[s])
            else:
                s = n % stages
                assert stage[s] == what, f'stage {s} holds {stage[s]}'
                readers[s].add(w)
                arrive(empty[s])
            reads[w].append(what)
            ci[w] += 1
    return reads


# (E, grid, chunks, stages, warps): the kernel's own ring (7 chunks of 64
# positions per edge, 3 stages, 4 consumer warps; 528 blocks on 132 SMs)
# around its grid, then other shapes
@pytest.mark.parametrize('E,grid,chunks,stages,warps', [
    (1, 528, 7, 3, 4), (527, 528, 7, 3, 4), (529, 528, 7, 3, 4),
    (1200, 528, 7, 3, 4), (5, 2, 7, 3, 4), (9, 1, 7, 3, 4),
    (7, 3, 14, 8, 4), (6, 2, 2, 2, 3), (4, 1, 1, 3, 2), (5, 2, 4, 1, 1)])
def test_ring_schedule_reads_each_stage_once(E, grid, chunks, stages,
                                             warps):
    """Every edge's g slot and every stage of every edge is filled once and
    read once by each consumer warp, in order, by one block; no stage or
    slot is overwritten before all warps read it, whatever the
    interleaving."""
    rng = np.random.RandomState(E * 7 + grid)
    sched = ring_schedule(E, grid, chunks)
    assert sorted(e for edges in sched for e in edges) == list(range(E))
    runs = 3 if E * chunks < 500 else 1
    for edges in sched[:3] + sched[-2:]:
        want = []
        for e in edges:
            want += [e] + [(e, c) for c in range(chunks)]
        for _ in range(runs):
            reads = _run_block(edges, chunks, stages, warps, rng)
            assert all(r == want for r in reads)
