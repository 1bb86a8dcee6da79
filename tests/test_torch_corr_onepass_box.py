"""The union-box rule of the bf16 correlation kernel (csrc/corr_onepass.cu:
corr_box_kernel), stated in plain PyTorch by ops/corr_onepass.py:box_fits /
box_rows, against a brute-force numpy statement over seeded coords: NaN and
infinite coords, coords far outside the map, both borders, small and wide
spreads. Also the kernel's dataflow (boxes staged with zeros outside the
map, taps of every box position, fitting pixels read at base + ty * stride
+ tx, overflowing ones from their own window) emulated in numpy against the
plain correlation, and the rule's constants against the kernel source."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import corr_case
from dpvo_torch.ops import corr_onepass
from dpvo_torch.ops.corr import corr_two_level as corr_plain

H1, W1 = 40, 56
H2, W2 = H1 // 4, W1 // 4
SRC = Path(corr_onepass.__file__).resolve().parent.parent / 'csrc' / \
    'corr_onepass.cu'


def _origin(v, dim):
    """The kernel's window origin on one axis, in numpy: np.fmax / np.fmin
    drop NaN as CUDA's fmaxf / fminf do."""
    return int(np.fmin(np.fmax(np.floor(v), np.float32(-16)),
                       np.float32(dim + 16))) - 3


def _brute(coords, box=12):
    """(E, 3, 3, 2) bool: every one of the 64 taps of the pixel's window
    lies in the box [bx, bx + box) x [by, by + box), (bx, by) the least
    window origin of the edge's nine pixels at that level; and (E, 2) the
    rows staged: min(box, columns spanned) * min(box, rows spanned)."""
    E = coords.shape[0]
    fits = np.zeros((E, 3, 3, 2), bool)
    rows = np.zeros((E, 2), np.int64)
    for e in range(E):
        for lvl, (H, W, s) in enumerate(((H1, W1, 1), (H2, W2, 4))):
            org = {(py, px): (_origin(coords[e, py, px, 0] / np.float32(s), W),
                              _origin(coords[e, py, px, 1] / np.float32(s), H))
                   for py in range(3) for px in range(3)}
            bx = min(o[0] for o in org.values())
            by = min(o[1] for o in org.values())
            span_x = max(o[0] for o in org.values()) + 8 - bx
            span_y = max(o[1] for o in org.values()) + 8 - by
            rows[e, lvl] = min(box, span_x) * min(box, span_y)
            for (py, px), (x0, y0) in org.items():
                fits[e, py, px, lvl] = all(
                    bx <= x0 + tx < bx + box and by <= y0 + ty < by + box
                    for ty in range(8) for tx in range(8))
    return fits, rows


def _check(coords):
    got = corr_onepass.box_fits(torch.from_numpy(coords), H1, W1, H2, W2)
    rows = corr_onepass.box_rows(torch.from_numpy(coords), H1, W1, H2, W2)
    ref, ref_rows = _brute(coords)
    assert got.shape == ref.shape and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(rows.numpy(), ref_rows)
    return ref


def _case_coords(E, seed):
    return corr_case(E, F=2, H1=H1, W1=W1, Ng=4, seed=seed)[3]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_matches_brute_force(seed):
    """corr_case's coords: interior, all four borders, negative, far
    outside; 1/16 of the edges with spreads up to ~18 px."""
    fits = _check(_case_coords(192, seed))
    # both branches at level 1 on this mix (level 2 overflows only past a
    # ~16 px spread at level 1, which few of these 12 wide edges reach)
    assert fits[..., 0].any() and not fits[..., 0].all()
    assert fits[..., 1].any()


def test_nan_and_infinite_coords():
    """NaN clamps to -16 (all taps outside), +-inf to the clamp bounds: a
    NaN pixel among finite ones stretches the box and may push the others
    out of it, as in the kernel."""
    coords = _case_coords(48, seed=3)
    coords[0, 1, 1, 0] = np.nan                   # one pixel, x only
    coords[1, :, :, :] = np.nan                   # the whole edge
    coords[2, 0, 2, 1] = np.nan
    coords[3, :, :, 0] = np.inf
    coords[4, :, :, 1] = -np.inf
    coords[5, 2, 0, :] = np.inf
    coords[6, :, :, 0] = np.nan
    coords[6, :, :, 1] = np.inf
    fits = _check(coords)
    assert fits[1].all() and fits[3].all() and fits[4].all() and fits[6].all()
    assert not fits[0, ..., 0].all()


def test_far_outside_and_both_borders():
    """Every pixel near x = 0, x = W, y = 0, y = H (either side), or far
    outside at either end, where the clamp gathers the origins."""
    rng = np.random.RandomState(4)
    centres = []
    for cx, cy in ((0.0, H1 / 2), (W1, H1 / 2), (W1 / 2, 0.0),
                   (W1 / 2, H1), (-40 * W1, H1 / 2), (W1 / 2, 50 * H1),
                   (-W1 - 18, -H1 - 17), (W1 + 15.5, H1 + 16.5)):
        centres += [(cx + dx, cy + dy) for dx, dy in
                    rng.uniform(-6, 6, (12, 2))]
    c = np.array(centres, np.float32)
    off = np.linspace(-1.5, 1.5, 3, dtype=np.float32)
    coords = np.stack(np.broadcast_arrays(
        c[:, None, None, 0] + off[None, None, :],
        c[:, None, None, 1] + off[None, :, None]), -1).astype(np.float32)
    _check(coords)


def test_small_spread_fits_box():
    """A patch spread of up to 4 px at level 1 fits its box at both levels,
    and the box stages at most 12 x 12 rows per level."""
    rng = np.random.RandomState(5)
    E = 96
    cx = rng.uniform(-4, W1 + 4, E)
    cy = rng.uniform(-4, H1 + 4, E)
    sp = rng.uniform(0.0, 1.9, (2, E))
    off = np.linspace(-1.0, 1.0, 3)
    coords = np.stack(np.broadcast_arrays(
        cx[:, None, None] + sp[0, :, None, None] * off[None, None, :],
        cy[:, None, None] + sp[1, :, None, None] * off[None, :, None]),
        -1).astype(np.float32)
    assert _check(coords).all()


def test_wide_spread_overflows():
    """Spreads of 24-40 px: pixels overflow the box at both levels."""
    rng = np.random.RandomState(6)
    E = 48
    c = rng.uniform(10, 30, (E, 2))
    sp = rng.uniform(12, 20, (E, 1, 1))
    off = np.linspace(-1.0, 1.0, 3)
    coords = np.stack(np.broadcast_arrays(
        c[:, None, None, 0] + sp * off[None, None, :],
        c[:, None, None, 1] + sp * off[None, :, None]), -1).astype(np.float32)
    fits = _check(coords)
    assert not fits[..., 0].reshape(E, 9).all(1).any()
    assert not fits[..., 1].reshape(E, 9).all(1).any()


def test_constants_match_kernel_source():
    src = SRC.read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
    assert int(consts['kBox']) == corr_onepass.BOX
    assert int(consts['kR']) == corr_onepass.RADIUS


def _emulate(gmap, f1, f2, coords, kk, jj):
    """The bf16 kernel's dataflow in numpy, f32: per edge and level the box
    rows (zero outside the map), the taps of the 9 g rows with every box
    position in a flat [9][8 * ceil(n / 8)] buffer, each fitting pixel's
    8x8 taps at base + ty * stride + tx with base = p * ns + (y0 - by) * bw
    + (x0 - bx) and stride = bw, each overflowing pixel's from its own
    window; then the bilinear blend into [dx, dy, py, px, lvl]."""
    E = coords.shape[0]
    out = np.zeros((E, 7, 7, 3, 3, 2), np.float32)
    ct = torch.from_numpy(coords)
    fits = corr_onepass.box_fits(ct, H1, W1, H2, W2).numpy().reshape(E, 9, 2)
    for lvl, (fm, c) in enumerate(((f1, ct), (f2, ct / 4.0))):
        H, W = fm.shape[1:3]
        x0, y0, bx, by, bw, bh = (a.numpy() for a in
                                  corr_onepass._level_boxes(c, H, W))
        cn = c.numpy().reshape(E, 9, 2)
        for e in range(E):
            frame, g = fm[jj[e]], gmap[kk[e]].reshape(9, 128)

            def row(y, x):
                inside = 0 <= y < H and 0 <= x < W
                return frame[y, x] if inside else np.zeros(128, np.float32)

            n = bw[e] * bh[e]
            ns = 8 * ((n + 7) // 8)
            box = np.stack([row(by[e] + q // bw[e], bx[e] + q % bw[e])
                            for q in range(n)])
            taps = np.zeros(9 * ns, np.float32)
            taps.reshape(9, ns)[:, :n] = g @ box.T
            for p in range(9):
                if fits[e, p, lvl]:
                    base = p * ns + (y0[e, p] - by[e]) * bw[e] + \
                        (x0[e, p] - bx[e])
                    t = np.array([[taps[base + ty * bw[e] + tx]
                                   for tx in range(8)] for ty in range(8)])
                else:
                    t = np.array([[g[p] @ row(y0[e, p] + ty, x0[e, p] + tx)
                                   for tx in range(8)] for ty in range(8)])
                fx, fy = cn[e, p] - np.floor(cn[e, p])
                o = ((1 - fx) * (1 - fy) * t[:7, :7] + fx * (1 - fy) *
                     t[:7, 1:] + (1 - fx) * fy * t[1:, :7] +
                     fx * fy * t[1:, 1:])
                out[e, :, :, p // 3, p % 3, lvl] = o.T      # [dx, dy]
    return out


def test_box_dataflow_matches_plain():
    """Both branches (1/16 of corr_case's edges have wide spreads, several
    sit on the borders or far outside) reproduce the plain correlation."""
    E = 64
    gmap, f1, f2, coords, kk, jj = corr_case(E, F=2, H1=H1, W1=W1, Ng=8,
                                             seed=7)
    # bf16 values, f32 arithmetic: what the kernel reads
    gmap, f1, f2 = (torch.from_numpy(a).to(torch.bfloat16).float().numpy()
                    for a in (gmap, f1, f2))
    fits = corr_onepass.box_fits(torch.from_numpy(coords), H1, W1, H2, W2)
    assert fits.any() and not fits.all()
    ref = corr_plain(*(torch.from_numpy(a) for a in
                       (gmap, f1, f2, coords, kk, jj))).numpy()
    got = _emulate(gmap, f1, f2, coords, kk, jj)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
