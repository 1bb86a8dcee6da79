"""The kernels on the planes ring (csrc/planes_ring.cuh:ring_body) on the
CPU: K2 for bf16 maps (csrc/corr_fused.cu:corr_planes_ring) and the probes
K5 (planes_roll), K7 (planes_first49, both variants) and K8
(planes_w12x16, planes_fixedw) of csrc/corr_probes.cu:probe_planes_ring.
Their dataflow emulated in numpy against the plain planes
(ops/corr_fused.py:planes_plain, ops/corr_probes.py:planes_*_plain), their
constants read from the sources, and the ring's barrier-parity protocol
run in random interleavings.

The emulation follows the kernel step by step: per edge its window bases
(far above the map for an edge whose source row or frame is out of range;
(0, 0) for fixedw) and rolls (K5, each taken modulo its level's positions),
per producer lane r its window row's in-map run of positions, landing in
the ring at the same positions or, rolled, at slot (q - sh) mod N of its
level in at most two pieces, per stage of `rows` positions the part of each
piece that falls in it (one bulk copy; every other slot keeps the stale row
of an earlier stage, poisoned with NaN here, as is the g slot of an edge
that copies none), the mma dot with the channels permuted identically in A
and B (f32 sums of bf16 inputs, one per k-step of 16 channels), and the
epilogue that writes columns whose (rolled) position lies outside the map
as zero, trades columns within each quad of lanes so that a warp stores a
pair of tiles 16 columns at a time, and rounds to bf16. K7's ring holds
the first 64 positions of each level (its producer lanes own the 7 window
rows that hold them), copies and computes only the first 56 (the tiles
that hold its kept columns; each run cut there) and stores the first 49
columns of each level as f32.
Bound against the plain version: one bf16 rounding of the same f32 sums in
another order, 2^-7 |plain| + 1e-5 max|plain| (K7's f32: the sum order
only, 1e-5 max|plain|); entries outside the map exactly zero."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_fused as cf
from dpvo_torch.ops import corr_probes as cp

CSRC = Path(cf.__file__).resolve().parent.parent / 'csrc'
SRC = CSRC / 'corr_fused.cu'
PROBES_SRC = CSRC / 'corr_probes.cu'
C, P2 = cf.C, cf.P2
N1, N2 = cf.WY * cf.WX, cf.WY2 * cf.WX2
FAR = -(1 << 28)


class Spec:
    """One kernel on the ring: its windows (wy1, wx1, wy2, wx2), its ring
    (stages, rows per stage, consumer warps), whether it rolls (K5), puts
    its windows at (0, 0) (fixedw), takes its g rows as g[kk[e]] (K2) or
    g[e], computes only the first `pos` positions of each level and keeps
    the first `keep` columns as f32 (K7; else whole bf16 planes)."""

    def __init__(self, key, wins, ring, roll=False, fixed=False, kk=False,
                 pos=None, keep=0):
        self.key = key
        (self.wy1, self.wx1), (self.wy2, self.wx2) = wins
        self.stages, self.rows, self.warps = ring[:3]
        self.roll, self.fixed, self.kk = roll, fixed, kk
        self.n1, self.n2 = pos or (self.wy1 * self.wx1, self.wy2 * self.wx2)
        self.n = self.n1 + self.n2
        # the window rows that hold those positions (one producer lane each)
        self.rows1 = -(-self.n1 // self.wx1)
        self.rows2 = -(-self.n2 // self.wx2)
        self.keep = keep
        # the positions of each level copied and computed: the tiles that
        # hold the kept columns
        self.live1, self.live2 = ((-(-keep // 8) * 8,) * 2 if keep else
                                  (self.n1, self.n2))
        self.live = self.live1 + self.live2


K2_WINS = ((cf.WY, cf.WX), (cf.WY2, cf.WX2))
SPECS = {
    'corr_planes': Spec('corr_planes', K2_WINS, (cf.RING_STAGES,
                                                  cf.RING_ROWS,
                                                  cf.RING_WARPS), kk=True),
    'planes_roll': Spec('planes_roll', K2_WINS, cp.PLANES_RING['planes_roll'],
                        roll=True),
    'planes_w12x16': Spec('planes_w12x16', (cp.WV, cp.WV),
                          cp.PLANES_RING['planes_w12x16']),
    'planes_fixedw': Spec('planes_fixedw', (cp.WV, cp.WV),
                          cp.PLANES_RING['planes_fixedw'], fixed=True),
    **{k: Spec(k, K2_WINS, cp.PLANES_RING[k], pos=(cp.FIRST_POS,) * 2,
               keep=cp.FIRST) for k in cp.FIRST49},
}


def _row_run(sp, r, base, H1, W1, H2, W2):
    """The kernel's row_run: window row r of an edge (r < rows1 at level
    1, then level 2) as (qa, qb, y, x0, level 2?): its positions [qa, qb)
    whose pixels lie in the map (and among its level's first live1 /
    live2),
    from map pixel (y, x0) on; qa >= qb for none (and for the producer
    lanes past the windows' rows, which own none)."""
    l2 = r >= sp.rows1
    wy, wx = (r - sp.rows1, sp.wx2) if l2 else (r, sp.wx1)
    y = (base[2] if l2 else base[0]) + wy
    bx = base[3] if l2 else base[1]
    W = W2 if l2 else W1
    x0, x1 = max(bx, 0), min(bx + wx, W)
    if r >= sp.rows1 + sp.rows2 or not 0 <= y < (H2 if l2 else H1) or \
            x0 >= x1:
        return 0, 0, 0, 0, l2
    q0 = (sp.n1 if l2 else 0) + wy * wx - bx
    return (q0 + x0, min(q0 + x1, sp.n1 + sp.live2 if l2 else sp.live1), y,
            x0, l2)


def _pieces(sp, r, qa, qb, sh):
    """Where the run [qa, qb) of producer lane r lands in the ring's edge
    positions: [(slot, n, row of the run)], one piece, or with a roll that
    wraps it at its level's end two (the kernel's pa, na, pb, nb)."""
    pa, na = qa, qb - qa
    if not sp.roll:
        return [(pa, na, 0)]
    l2 = r >= sp.rows1
    off, n = (sp.n1, sp.n2) if l2 else (0, sp.n1)
    pa -= sh[1] if l2 else sh[0]
    if pa < off:
        pa += n
    over = pa + na - (off + n)
    if over <= 0:
        return [(pa, na, 0)]
    return [(pa, na - over, 0), (off, over, na - over)]


def _stage_copies(sp, c, base, sh, H1, W1, H2, W2):
    """The bulk copies of stage c (ring positions [c * rows, + rows)), one
    per piece of a producer lane's run that meets it: (slot, y, x, count,
    level 2?)."""
    Q = sp.rows
    out = []
    for lane in range(32):
        qa, qb, y, x0, l2 = _row_run(sp, lane, base, H1, W1, H2, W2)
        for pa, na, k in _pieces(sp, lane, qa, qb, sh):
            lo = max(pa, c * Q)
            n = min(pa + na, c * Q + Q) - lo
            if n > 0:
                out.append((lo, y, x0 + k + lo - pa, n, l2))
    return out


def _edge(sp, e, Ng, F, kk, jj, by1, bx1, by2, bx2, sh1, sh2):
    """What the producer reads of edge e: (ok, bases, rolls)."""
    ok = 0 <= jj[e] < F and (not sp.kk or 0 <= kk[e] < Ng)
    base = (0, 0, 0, 0) if sp.fixed else (by1[e], bx1[e], by2[e], bx2[e])
    sh = (int(sh1[e]) % sp.n1, int(sh2[e]) % sp.n2) if sp.roll else (0, 0)
    return ok, (base if ok else (FAR, 0, FAR, 0)), sh


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


def _in_map(sp, l2, q, base, H1, W1, H2, W2):
    """Whether window position(s) q of a level lie in the map."""
    by, bx, wx, H, W = ((base[2], base[3], sp.wx2, H2, W2) if l2 else
                        (base[0], base[1], sp.wx1, H1, W1))
    y, x = by + q // wx, bx + q % wx
    return (y >= 0) & (y < H) & (x >= 0) & (x < W)


def _emulate(sp, g, f1, f2, kk, jj, by1, bx1, by2, bx2, sh1, sh2):
    """The ring kernel's dataflow for spec sp in numpy (module docstring).
    Returns the planes (E, 9, n1), (E, 9, n2) as bf16 tensors (K7: the
    first `keep` columns of each as f32) and the window rows copied per
    edge."""
    E, Ng, F = len(jj), g.shape[0], f1.shape[0]
    H1, W1, H2, W2 = f1.shape[1], f1.shape[2], f2.shape[1], f2.shape[2]
    Q = sp.rows
    out = np.zeros((E, P2, sp.n), np.float32)
    copied = np.zeros(E, np.int64)
    ksteps = _kstep_channels()
    stale = np.full((Q, C), np.nan, np.float32)
    for e in range(E):
        ok, base, sh = _edge(sp, e, Ng, F, kk, jj, by1, bx1, by2, bx2, sh1,
                             sh2)
        a = np.zeros((16, C), np.float32)          # rows 9-15 zero
        if ok:
            a[:P2] = g[kk[e]] if sp.kk else g[e]
        else:
            a[:P2] = np.nan                        # no copy: a stale slot
        for c in range(sp.n // Q):
            stage = stale.copy()
            for q, y, x, n, l2 in _stage_copies(sp, c, base, sh, H1, W1, H2,
                                                W2):
                frame = (f2 if l2 else f1)[jj[e]]
                stage[q - c * Q:q - c * Q + n] = frame[y, x:x + n]
                copied[e] += n
            d = np.zeros((16, Q), np.float32)
            for ch in ksteps:
                d += (a[:, ch] @ stage[:, ch].T).astype(np.float32)
            masked = np.zeros((P2, Q), np.float32)
            for t in range(Q // 8):                # the epilogue's masks
                tq = c * Q // 8 + t
                l2 = tq >= sp.n1 // 8
                n = sp.n2 if l2 else sp.n1
                col = (tq - sp.n1 // 8 if l2 else tq) * 8 + np.arange(8)
                q = (col + sh[l2]) % n              # the rolled position
                inside = _in_map(sp, l2, q, base, H1, W1, H2, W2)
                masked[:, t * 8:t * 8 + 8] = np.where(
                    inside, d[:P2, t * 8:t * 8 + 8], 0.0)
            for t in range(0, Q // 8, 2):          # a warp's tile pair
                pair = masked[:, t * 8:t * 8 + 16]
                col = c * Q + t * 8                # edge position of tile t
                # K7's f32 stores: each lane its own columns
                out[e, :, col:col + 16] = pair if sp.keep else \
                    pair[:, _PAIR_COLS]
    if sp.keep:
        planes = torch.from_numpy(out)
        return (planes[..., :sp.keep], planes[..., sp.n1:sp.n1 + sp.keep],
                copied)
    planes = torch.from_numpy(out).to(torch.bfloat16)
    return planes[..., :sp.n1], planes[..., sp.n1:], copied


def _case(sp, seed, E=60, F=3, Ng=8, H1=48, W1=80):
    """bf16-valued g (Ng rows for K2, one per edge else) and maps, and
    window bases at all four borders of each level, far outside (past
    window_base's clamp, at both ends), negative bx, wholly inside; kk /
    jj out of range (-1, Ng, F) on a few edges; rolls zero, odd, negative,
    at and past the level's positions, and the int32 extremes."""
    rng = np.random.RandomState(seed)
    H2, W2 = H1 // 4, W1 // 4

    def bf(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            torch.bfloat16).float().numpy()

    g = bf(Ng if sp.kk else E, P2, C)
    f1, f2 = bf(F, H1, W1, C), bf(F, H2, W2, C)
    by1 = rng.randint(-14, H1 + 2, E)
    bx1 = 8 * rng.randint(-4, W1 // 8 + 1, E)
    by2 = rng.randint(-12, H2 + 2, E)
    bx2 = 4 * rng.randint(-5, W2 // 4 + 1, E)
    # the four borders, exactly and one past
    by1[:4] = [1 - sp.wy1, H1 - sp.wy1, 0, H1 - 1]
    bx1[:4] = [0, 8, -sp.wx1, W1 - 8]
    by2[:4] = [1 - sp.wy2, H2 - sp.wy2, 0, H2 - 1]
    bx2[:4] = [-sp.wx2, W2 - sp.wx2, 0, W2 - 4]
    by1[4:6], bx1[4:6] = [-10 ** 6, 10 ** 6], [-10 ** 6, 10 ** 6]  # far
    by2[4:6], bx2[4:6] = [10 ** 6, -10 ** 6], [10 ** 6, -10 ** 6]
    by1[11], bx1[11], bx2[11] = 10, 16, 2                   # inside
    by2[11] = min(1, H2 - sp.wy2)
    kk = rng.randint(0, Ng, E)
    jj = np.sort(rng.randint(0, F, E))
    kk[6], jj[7], kk[8], jj[9], kk[10], jj[10] = -1, -1, Ng, F, Ng + 5, -3
    sh1 = rng.randint(-3 * sp.n1, 3 * sp.n1, E)
    sh2 = rng.randint(-3 * sp.n2, 3 * sp.n2, E)
    for sh, n in ((sh1, sp.n1), (sh2, sp.n2)):
        sh[12:22] = [0, 1, -1, -7, n, n + 3, 2 * n - 1, -n, 2 ** 31 - 1,
                     -2 ** 31]
    return [a.astype(np.int32) if a.dtype.kind == 'i' else a
            for a in (g, f1, f2, kk, jj, by1, bx1, by2, bx2, sh1, sh2)]


def _plain(sp, g, f1, f2, kk, jj, by1, bx1, by2, bx2, sh1, sh2):
    """The plain version of spec sp on the case, as (E, 9, n1), (E, 9,
    n2) bf16."""
    t = [torch.from_numpy(a) for a in (g, f1, f2)]
    g, f1, f2 = (a.to(torch.bfloat16) for a in t)
    i = [torch.from_numpy(a) for a in (kk, jj, by1, bx1, by2, bx2, sh1,
                                       sh2)]
    kk, jj, by1, bx1, by2, bx2, sh1, sh2 = i
    if sp.kk:
        p1, p2 = cf.planes_plain(g, f1, f2, kk, jj, by1, bx1, by2, bx2)
        return p1.flatten(2), p2.flatten(2)
    if sp.roll:
        return cp.planes_roll_plain(g, f1, f2, jj, by1, bx1, by2, bx2, sh1,
                                    sh2)
    if sp.fixed:
        return cp.planes_fixedw_plain(g, f1, f2, jj)
    if sp.keep:
        E = len(jj)
        return [p.reshape(E, P2, sp.keep) for p in cp.planes_first49_plain(
            g, f1, f2, jj, by1, bx1, by2, bx2)]
    return cp.planes_w12x16_plain(g, f1, f2, jj, by1, bx1, by2, bx2)


def _rows_in_map(sp, case):
    """The window positions in the map per edge: what the kernel copies."""
    g, f1, f2, kk, jj, by1, bx1, by2, bx2 = [torch.from_numpy(a)
                                             for a in case[:9]]
    shp = (f1.shape[0], *f1.shape[1:3], *f2.shape[1:3])
    if sp.kk:
        return cf.window_rows(kk, jj, by1, bx1, by2, bx2, g.shape[0], *shp)
    if sp.fixed:
        by1 = bx1 = by2 = bx2 = torch.zeros_like(jj)
    return cp.ring_rows(sp.key, jj, by1, bx1, by2, bx2, *shp)


# (spec, seed, level-1 map): K2's cases keep their ids (the seed), the
# probes' run at 48x80 and on maps smaller than their windows
DATAFLOW = ([('corr_planes', s, (48, 80)) for s in (0, 1, 2)] +
            [(k, s, hw) for k in ('planes_roll', 'planes_w12x16',
                                  'planes_fixedw', *cp.FIRST49)
             for s, hw in ((0, (48, 80)), (1, (48, 80)), (2, (10, 12)))])


@pytest.mark.parametrize(
    'key,seed,hw', DATAFLOW,
    ids=[str(s) if k == 'corr_planes' else f'{k}-{s}-{hw[0]}x{hw[1]}'
         for k, s, hw in DATAFLOW])
def test_ring_dataflow_matches_plain(key, seed, hw):
    sp = SPECS[key]
    case = _case(sp, seed, H1=hw[0], W1=hw[1])
    p1, p2, copied = _emulate(sp, *case)
    for got, r in zip((p1, p2), _plain(sp, *case)):
        assert got.dtype == r.dtype and got.shape == r.shape
        got, r = got.float(), r.float()
        assert torch.isfinite(got).all()     # no stale row leaks a NaN
        bound = 1e-5 * r.abs().max()
        if not sp.keep:
            bound = bound + 2 ** -7 * r.abs()
        assert bool(((got - r).abs() <= bound).all()), \
            (got - r).abs().max()
        assert bool((got[r == 0] == 0).all())
    np.testing.assert_array_equal(copied, _rows_in_map(sp, case).numpy())
    # the case reaches every branch: edges copying nothing, whole windows
    # (on maps that hold them), partial rows (where bases vary or the map
    # is smaller than the windows), zero planes for bad kk / jj
    big = hw == (48, 80)
    assert (copied == 0).any()
    assert (copied == sp.live).any() == big
    assert ((copied > 0) & (copied < sp.live)).any() == (not big or
                                                         not sp.fixed)
    bad = (6, 7, 8, 9, 10) if sp.kk else (7, 9, 10)
    for e in bad:
        assert not p1[e].float().any() and not p2[e].float().any()


def test_copies_cover_in_map_positions():
    """For each kernel on the ring, the producer lanes' bulk copies, over
    the stages of an edge, copy exactly the in-map positions of both
    windows, each once, into the stage slot of their (rolled) position."""
    rng = np.random.RandomState(3)
    H1, W1, H2, W2 = 17, 29, 5, 7
    for sp in SPECS.values():
        for _ in range(200):
            base = (rng.randint(-14, H1 + 2), rng.randint(-30, W1 + 2),
                    rng.randint(-12, H2 + 2), rng.randint(-18, W2 + 2))
            sh = ((rng.randint(sp.n1), rng.randint(sp.n2)) if sp.roll else
                  (0, 0))
            seen = []
            for c in range(sp.n // sp.rows):
                for q, y, x, n, l2 in _stage_copies(sp, c, base, sh, H1, W1,
                                                    H2, W2):
                    assert c * sp.rows <= q and \
                        q + n <= (c + 1) * sp.rows
                    seen += [(q + i, y, x + i, l2) for i in range(n)]
            want = []
            for s in range(sp.n):                  # ring slot s holds ...
                # (K7: the first live1 / live2 positions of each level)
                l2 = s >= sp.n1
                off, n = (sp.n1, sp.n2) if l2 else (0, sp.n1)
                q = (s - off + sh[l2]) % n         # ... window position q
                if q >= (sp.live2 if l2 else sp.live1):
                    continue
                wx = sp.wx2 if l2 else sp.wx1
                y = (base[2] if l2 else base[0]) + q // wx
                x = (base[3] if l2 else base[1]) + q % wx
                if 0 <= y < (H2 if l2 else H1) and \
                        0 <= x < (W2 if l2 else W1):
                    want.append((s, y, x, l2))
            assert (sorted(seen) if sp.roll else seen) == want


def _source_consts():
    src = SRC.read_text()
    consts = {}
    for name, val in re.findall(r'\b(k\w+) = (-?\d+)[,;]', src):
        consts.setdefault(name, int(val))
    ring = re.search(r'struct PlanesRing \{\s*static constexpr int '
                     r'kStages = (\d+), kRows = (\d+), kWarps = (\d+), '
                     r'kBlocksPerSm = (\d+);', src)
    return consts, tuple(int(v) for v in ring.groups())


def _probe_source_rings():
    """{key: ((stages, rows, warps, blocks per SM), which)} of each
    ProbeRing<P> of csrc/corr_probes.cu, `which` being P's value in the
    RingProbe enum (the shape query's argument)."""
    src = PROBES_SRC.read_text()
    enum = re.search(r'enum RingProbe \{([^}]*)\}', src).group(1)
    which = {k: int(v) for k, v in re.findall(r'(k\w+) = (\d+)', enum)}
    rings = {}
    for p, key, *vals in re.findall(
            r'struct ProbeRing<(k\w+)> \{  // (\w+)\s*static constexpr int '
            r'kStages = (\d+), kRows = (\d+), kWarps = (\d+), '
            r'kBlocksPerSm = (\d+);', src):
        rings[key] = (tuple(int(v) for v in vals), which[p])
    return rings


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


@pytest.mark.parametrize('key', ['planes_roll', 'planes_w12x16',
                                 'planes_fixedw', *cp.FIRST49])
def test_probe_ring_constants_match_source(key):
    """Each probe's ring in csrc/corr_probes.cu is the one ops/corr_probes
    names, its shape-query number the wrapper's, its stages hold whole
    tile pairs of whole edges, and its blocks fit an SM; K7's positions
    and kept columns are the wrapper's."""
    ring, which = _probe_source_rings()[key]
    assert ring == cp.PLANES_RING[key]
    assert which == cp._RING_WHICH[key]
    sp = SPECS[key]
    stages, rows, warps, blocks = ring
    assert sp.n % rows == 0 and rows % 16 == 0 and sp.n1 % 16 == 0
    slot = P2 * C * 2 + (32 if sp.roll else 16)
    if sp.keep:
        src = PROBES_SRC.read_text()
        assert re.search(r'kPos1 = (\d+), kPos2 = (\d+), kKeep = kFirst;',
                         src).groups() == (str(sp.n1), str(sp.n2))
        assert re.search(r'kFirst = (\d+);', src).group(1) == str(sp.keep)
        assert sp.rows1 + sp.rows2 == 7      # window rows per edge
        # each consumer warp has a slot of 9 x 16 f32
        slot_pairs = warps * P2 * 16 * 4
    else:
        slot_pairs = 0
    smem = stages * rows * C * 2 + 2 * slot + 8 * (2 * stages + 4) + \
        slot_pairs
    assert smem == cp.ring_smem(key)
    assert (smem + 1024) * blocks <= 228 * 1024


def _stream_reads(E, nS, idle):
    """First49Spec::streams' reads over the grid: per edge e and idle
    producer lane k, the rows e * 9 + k (k < 9) of s1, s2, fr1, fr2, and
    the elements i = e * 32 + j, j in (k, k + idle) below 32, and i + m *
    E * 32 below nS, of S1 (S2 alike). Returns (rows read, S elements
    read), each a list with repeats."""
    rows, elems = [], []
    for e in range(E):
        for k in range(idle):
            if k < P2:
                rows.append(e * P2 + k)
            for j in (k, k + idle):
                i = e * 32 + j
                while j < 32 and i < nS:
                    elems.append(i)
                    i += E * 32
    return rows, elems


@pytest.mark.parametrize('E', [1, 7, 64, 257, 258, 1000])
def test_first49_streams_read_each_element_once(E):
    """K7 STREAMS=1: the producer lanes past K7's 7 window rows read every
    row of s1, s2, fr1, fr2 and every element of S1 (7 x 24 x 49) and S2
    (7 x 16 x 49) exactly once over the grid, whatever E; no lane that
    copies a window row reads a stream."""
    sp = SPECS['planes_first49_streams']
    idle = 32 - sp.rows1 - sp.rows2
    assert idle == 25
    src = PROBES_SRC.read_text()
    assert 'const int j = k + kIdle * h;' in src
    for nS in (7 * cp.WX * cp.FIRST, 7 * cp.WX2 * cp.FIRST):
        rows, elems = _stream_reads(E, nS, idle)
        assert sorted(rows) == list(range(E * P2))
        assert sorted(elems) == list(range(nS))


def ring_schedule(E, grid, chunks):
    """corr_planes_ring's and probe_planes_ring's order of work
    (csrc/planes_ring.cuh): block b takes edges b, b + grid, ...; per edge
    one g-slot fill, then `chunks` stage fills. Returns, per block, the
    list of its edges."""
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


# (E, grid, chunks, stages, warps): K2's ring (7 chunks of 64 positions
# per edge, 3 stages, 4 consumer warps; 528 blocks on 132 SMs) around its
# grid, K5's (7 chunks, 3 stages, 2 warps), K8's (6 chunks, whole laps of
# the ring; 3 stages, 2 warps) and K7's (one chunk of 128 per edge on 2
# stages, 4 warps, 396 blocks; 2 chunks of 64 on 3 stages in its sweep),
# then other shapes
@pytest.mark.parametrize('E,grid,chunks,stages,warps', [
    (1, 528, 7, 3, 4), (527, 528, 7, 3, 4), (529, 528, 7, 3, 4),
    (1200, 528, 7, 3, 4), (5, 2, 7, 3, 4), (9, 1, 7, 3, 4),
    (529, 528, 7, 3, 2), (9, 1, 7, 3, 2),
    (1, 528, 6, 3, 2), (529, 528, 6, 3, 2), (1100, 528, 6, 3, 2),
    (9, 1, 6, 3, 2), (7, 2, 6, 2, 4), (8, 3, 6, 4, 4),
    (1, 396, 1, 2, 4), (397, 396, 1, 2, 4), (1200, 396, 1, 2, 4),
    (9, 1, 1, 2, 4), (529, 528, 2, 3, 2), (9, 1, 2, 3, 2),
    (9, 1, 1, 1, 2), (7, 2, 1, 1, 4),
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
