"""The training correlation's gradient (dpvo_torch/ops/corr_grad.py).

On the CPU: corr_two_level_train's gradients with respect to gmap, fmap1
and fmap2 against jax.grad of dpvo_tpu/ops/corr.py:corr at both levels, on
maps large enough for its gather path and small enough for its all-matmul
path (H * W <= 512, the same function), with fractional coords, borders,
windows partly and wholly outside the map, far-off coords, repeated kk and
NaN coords. Tolerance 1e-5 * max|grad| in f32: both sum the same f32
products, in another order. A NaN coordinate touches no tap in the port
(K1's origin rule sends it to -16) and gets no gradient; in dpvo_tpu its
NaN bilinear weights reach the maps, so its gradient is NaN there (checked
below, and the rest held against jax.grad without those edges).
corr_backward_plain against autograd of the port's ops/corr.py at 1e-6
relative (the same arithmetic, summed in another order).

The card's design (csrc/corr_backward.cu: records, frame lists, target
tiles that sum the map gradient in shared memory) is emulated in numpy
(bw_records, bw_lists, bw_tile_entries, bw_dataflow): its entries, batches
and per-tile sums must give corr_backward_plain's gradients, with edges
across tile and map borders, NaN / far-off edges, all-zero output-gradient
rows, overflow pixels and a batch cap that splits one tile; its constants
are the source's.

On the card (marked cuda, skipped without one): the kernels against
corr_backward_plain, for f32 and bf16 maps, on edge counts around the grid,
on a side stream, with 80% of the output-gradient rows zero, every edge on
one tile, overflow-heavy coords, dfmap1 / dfmap2 bit-identical over two
launches, the work the binning made against the emulation, and the
refusals. Run there with `python -m pytest tests/test_torch_corr_grad.py
-q`.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_grad, corr_onepass
from dpvo_torch.ops.corr import corr_two_level as corr_plain
from dpvo_torch.ops.corr_grad import (corr_backward, corr_backward_plain,
                                      corr_two_level_train)
from dpvo_torch.ops.patchify import avg_pool2d
from dpvo_tpu.ops.corr import corr as jax_corr
from dpvo_tpu.ops.patchify import avg_pool2d as jax_avg_pool2d
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')

N_NAN = 6       # edges 0 .. 5 have NaN coords (all pixels or some)
N_FAR = 6       # edges 6 .. 11 lie 40 map sizes away (3 each side)


def _case(H, W, seed, E=240, F=3, Ng=6):
    """Seeded maps, coords and an output gradient: 3x3 grids of spread up
    to ~1.5 px around centers from 12 px outside to 12 px inside every
    border; Ng = 6 patches for 240 edges, so kk repeats."""
    rng = np.random.RandomState(seed)
    g = rng.randn(Ng, 3, 3, 128).astype(np.float32)
    f1 = rng.randn(F, H, W, 128).astype(np.float32)
    f2 = rng.randn(F, H // 4, W // 4, 128).astype(np.float32)
    cx = rng.uniform(-12, W + 12, (E, 1, 1))
    cy = rng.uniform(-12, H + 12, (E, 1, 1))
    co = np.stack([cx + rng.uniform(-1.5, 1.5, (E, 3, 3)),
                   cy + rng.uniform(-1.5, 1.5, (E, 3, 3))], -1)
    co = co.astype(np.float32)
    co[:3] = np.nan
    co[3:N_NAN, 1, 2, 0] = np.nan
    far = 40.0 * max(H, W)
    co[N_NAN:N_NAN + N_FAR // 2] -= far
    co[N_NAN + N_FAR // 2:N_NAN + N_FAR] += far
    kk = rng.randint(0, Ng, E).astype(np.int32)
    jj = rng.randint(0, F, E).astype(np.int32)
    go = rng.randn(E, 7, 7, 3, 3, 2).astype(np.float32)
    return g, f1, f2, co, kk, jj, go


def _jax_grads(g, f1, f2, co, kk, jj, go):
    def f(gj, a, b):
        c1 = jax_corr(gj, a, jnp.asarray(co), jnp.asarray(kk),
                      jnp.asarray(jj))
        c2 = jax_corr(gj, b, jnp.asarray(co) / 4.0, jnp.asarray(kk),
                      jnp.asarray(jj))
        out = jnp.stack([c1, c2], -1)
        return jnp.sum(out * go), out
    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(g), jnp.asarray(f1), jnp.asarray(f2))
    return np.asarray(out), [np.asarray(x) for x in grads]


def _finite(c):
    """The case with each NaN coordinate moved 1000 px off the map: no tap
    in the map, so nothing to add in either package."""
    co = np.where(np.isnan(c[3]), -1000.0, c[3]).astype(np.float32)
    return (*c[:3], co, *c[4:])


# (24, 32): dpvo_tpu's gather path; (16, 20): its all-matmul path
@pytest.fixture(scope='module', params=[(24, 32), (16, 20)],
                ids=['gather', 'volume'])
def case(request):
    H, W = request.param
    c = _case(H, W, seed=H)
    out, grads = _jax_grads(*_finite(c))
    _, grads_nan = _jax_grads(*c)
    return c, out, grads, grads_nan


def _port(g, f1, f2, co, kk, jj, go, dtype=torch.float32):
    maps = [torch.tensor(a).to(dtype).requires_grad_(True)
            for a in (g, f1, f2)]
    out = corr_two_level_train(*maps, torch.from_numpy(co),
                               torch.from_numpy(kk), torch.from_numpy(jj))
    grads = torch.autograd.grad((out * torch.from_numpy(go)).sum(), maps)
    return out.detach(), grads


def test_grads_match_jax(case):
    c, out_j, grads_j, grads_nan = case
    out, grads = _port(*c)
    for a, b in zip(grads, grads_j):
        assert bool(torch.isfinite(a).all())
        tol = 1e-5 * np.abs(b).max()
        np.testing.assert_allclose(a.numpy(), b, atol=tol, rtol=0)
    # forward: the K1 function on the CPU (ops/corr.py) against dpvo_tpu;
    # a NaN coordinate's outputs are NaN (its bilinear weights), no other
    o = out.numpy()
    nan_px = np.isnan(c[3]).any(-1)[:, None, None, :, :, None]
    assert np.array_equal(np.isnan(o), np.broadcast_to(nan_px, o.shape))
    np.testing.assert_allclose(np.where(np.isnan(o), 0.0, o), out_j,
                               atol=1e-5 * np.abs(out_j).max(), rtol=0)
    # dpvo_tpu: NaN gradients where the NaN pixels' taps lie in the map
    assert all(np.isnan(x).any() for x in grads_nan)
    # the port: the all-NaN and the far-off edges add exactly nothing
    idx = np.r_[0:3, N_NAN:N_NAN + N_FAR]
    _, zero = _port(*(a[idx] if i >= 3 else a for i, a in enumerate(c)))
    assert not any(bool(z.any()) for z in zero)


def test_plain_backward_matches_autograd(case):
    """corr_backward_plain against autograd through ops/corr.py (finite
    coords: autograd there, like dpvo_tpu, is NaN at NaN coords)."""
    g, f1, f2, co, kk, jj, go = _finite(case[0])
    maps = [torch.tensor(a, requires_grad=True) for a in (g, f1, f2)]
    out = corr_plain(*maps, torch.from_numpy(co), torch.from_numpy(kk),
                     torch.from_numpy(jj))
    ref = torch.autograd.grad((out * torch.from_numpy(go)).sum(), maps)
    got = corr_backward_plain(*(torch.from_numpy(a) for a in
                                (g, f1, f2, co, kk, jj, go)))
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape
        tol = 1e-6 * b.abs().max().item()
        assert (a - b).abs().max().item() <= tol


def test_bf16_maps_round_once():
    """bf16 maps: the gradient is summed in f32 and rounded once, to bf16."""
    g, f1, f2, co, kk, jj, go = _case(24, 32, seed=5, E=96)
    m16 = [torch.from_numpy(a).to(torch.bfloat16) for a in (g, f1, f2)]
    args = (torch.from_numpy(co), torch.from_numpy(kk), torch.from_numpy(jj),
            torch.from_numpy(go))
    got = corr_backward(*m16, *args)
    ref = corr_backward_plain(*m16, *args)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))


def test_level2_gradient_reaches_fmap1_through_pooling():
    """fmap2 = avg_pool2d(fmap1, 4), as patchify builds it: the level-2
    gradient reaches fmap1 through plain autograd of the pooling, as in
    dpvo_tpu."""
    g, f1, _, co, kk, jj, go = _case(24, 32, seed=7, E=64)
    co, kk, jj, go = co[N_NAN:], kk[N_NAN:], jj[N_NAN:], go[N_NAN:]

    def f(gj, a):
        c1 = jax_corr(gj, a, jnp.asarray(co), jnp.asarray(kk),
                      jnp.asarray(jj))
        c2 = jax_corr(gj, jax_avg_pool2d(a, 4), jnp.asarray(co) / 4.0,
                      jnp.asarray(kk), jnp.asarray(jj))
        return jnp.sum(jnp.stack([c1, c2], -1) * go)
    ref = jax.grad(f, argnums=(0, 1))(jnp.asarray(g), jnp.asarray(f1))
    gt, ft = (torch.tensor(a, requires_grad=True) for a in (g, f1))
    out = corr_two_level_train(gt, ft, avg_pool2d(ft, 4).contiguous(),
                               torch.from_numpy(co), torch.from_numpy(kk),
                               torch.from_numpy(jj))
    got = torch.autograd.grad((out * torch.from_numpy(go)).sum(), (gt, ft))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(),
                                   rtol=0)


def test_no_gradient_to_coords():
    g, f1, f2, co, kk, jj, go = _case(16, 20, seed=9, E=32)
    maps = [torch.tensor(a, requires_grad=True) for a in (g, f1, f2)]
    c = torch.tensor(co, requires_grad=True)
    out = corr_two_level_train(*maps, c, torch.from_numpy(kk),
                               torch.from_numpy(jj))
    (out.nan_to_num() * torch.from_numpy(go)).sum().backward()
    assert c.grad is None
    assert all(m.grad is not None for m in maps)


# ---------------------------------------------------------------------------
# the card's design, emulated (csrc/corr_backward.cu)
# ---------------------------------------------------------------------------

SRC = Path(corr_grad.__file__).resolve().parent.parent / 'csrc' / \
    'corr_backward.cu'
# csrc/corr_backward.cu: kCap, kScan, kThreads, kBox, kFit
BW_CAP, BW_SCAN, BW_THREADS, BW_BOX, BW_FIT = 256, 4, 256, 12, 4
BOX_CODE = 15


def bw_records(co, kk, jj, go, Ng, F, dims):
    """bw_prep: per level (origins (E, 9, 2) int [x0, y0], fractions (E, 9,
    2) f32, box pixels (E, 9) bool, overflow pixels (E, 9) bool, the box
    entry's rectangle (E, 4) [x0, x1, y0, y1]) for dims ((H1, W1), (H2,
    W2)), and each edge's frame key (jj, or -1 with no pixel left)."""
    E = len(kk)
    ok = (kk >= 0) & (kk < Ng) & (jj >= 0) & (jj < F)
    c = co.reshape(E, 9, 2).astype(np.float32)
    levels, any_live = [], np.zeros(E, bool)
    for lvl, (H, W) in enumerate(dims):
        v = c / np.float32(4) if lvl else c
        fl = np.floor(v)
        frac = (v - fl).astype(np.float32)

        def origin(x, dim):
            x = np.where(np.isnan(x), -16.0, x)
            return np.clip(x, -16.0, dim + 16.0).astype(np.int64) - 3
        org = np.stack([origin(fl[..., 0], W), origin(fl[..., 1], H)], -1)
        ox, oy = org[..., 0], org[..., 1]
        inmap = (ox < W) & (ox + 8 > 0) & (oy < H) & (oy + 8 > 0)
        fit = ((ox - ox.min(1, keepdims=True) <= BW_FIT) &
               (oy - oy.min(1, keepdims=True) <= BW_FIT))
        live = ok & (go[..., lvl] != 0).reshape(E, -1).any(1)
        bm = inmap & fit & live[:, None]
        om = inmap & ~fit & live[:, None]
        big = 1 << 20
        rect = np.stack([np.where(bm, ox, big).min(1).clip(0, None),
                         np.where(bm, ox + 8, -big).max(1).clip(None, W),
                         np.where(bm, oy, big).min(1).clip(0, None),
                         np.where(bm, oy + 8, -big).max(1).clip(None, H)], -1)
        rect[~bm.any(1)] = 0
        levels.append((org, frac, bm, om, rect))
        any_live |= (bm | om).any(1)
    return levels, np.where(any_live, jj, -1)


def bw_lists(key, F):
    """bw_frames: each frame's edges in edge order."""
    return [np.nonzero(key == f)[0] for f in range(F)]


def _meets(x0, x1, y0, y1, t):
    tx0, tx1, ty0, ty1 = t
    return x0 < tx1 and x1 > tx0 and y0 < ty1 and y1 > ty0


def bw_tiles(dims, tiles, F):
    """The tile kernel's blocks in launch order, level-2 tiles first:
    (level, frame, (x0, x1, y0, y1) clipped to the map); tiles ((rows,
    columns) per level)."""
    out = []
    for lvl in (1, 0):
        (H, W), (TH, TW) = dims[lvl], tiles[lvl]
        for f in range(F):
            for y0 in range(0, H, TH):
                for x0 in range(0, W, TW):
                    out.append((lvl, f, (x0, min(x0 + TW, W), y0,
                                         min(y0 + TH, H))))
    return out


def bw_tile_entries(level, lst, t, cap=BW_CAP, scan=BW_SCAN,
                    threads=BW_THREADS):
    """One tile's entries [(edge, code)] in the order the block adds them
    (code BOX_CODE: the box entry; p: pixel p on its own), and its batches:
    rounds of scan x threads list edges whose entries are packed in list
    order up to the first edge whose entries do not fit `cap`; the next
    round starts at that edge."""
    org, _, bm, om, rect = level
    per_edge = []
    for e in lst:
        ent = []
        if bm[e].any() and _meets(*rect[e], t):
            ent.append((e, BOX_CODE))
        for p in np.nonzero(om[e])[0]:
            x0, y0 = org[e, p]
            if _meets(x0, x0 + 8, y0, y0 + 8, t):
                ent.append((e, int(p)))
        per_edge.append(ent)
    entries, batches, pos = [], [], 0
    while pos < len(lst):
        batch, taken = [], 0
        for ent in per_edge[pos:pos + scan * threads]:
            if len(batch) + len(ent) > cap:
                break
            batch += ent
            taken += 1
        pos += taken
        batches.append(batch)
        entries += batch
    return entries, batches


def _entry_rect(level, e, code, t):
    org, _, bm, _, rect = level
    if code == BOX_CODE:
        x0, x1, y0, y1 = rect[e]
        mask = bm[e]
    else:
        x0, y0 = org[e, code]
        x1, y1 = x0 + 8, y0 + 8
        mask = np.arange(9) == code
    tx0, tx1, ty0, ty1 = t
    return (max(x0, tx0), min(x1, tx1), max(y0, ty0), min(y1, ty1)), mask


def _dtq(level, go_l, e, mask, r):
    """The entry's tap gradients at its positions: (9, ny, nx) f32, K1's
    blend transposed, zero outside each masked pixel's window."""
    org, frac, *_ = level
    x0, x1, y0, y1 = r
    qy, qx = np.mgrid[y0:y1, x0:x1]
    g7 = go_l[e].reshape(7, 7, 9)                     # [dx, dy, p]
    out = np.zeros((9,) + qy.shape, np.float32)
    for p in np.nonzero(mask)[0]:
        ty, tx = qy - org[e, p, 1], qx - org[e, p, 0]
        fx, fy = frac[e, p]
        inw = (ty >= 0) & (ty < 8) & (tx >= 0) & (tx < 8)

        def g(dy, dx, ok):
            return np.where(ok, g7[dx.clip(0, 6), dy.clip(0, 6), p], 0.0)
        v = ((1 - fx) * (1 - fy) * g(ty, tx, (ty < 7) & (tx < 7)) +
             fx * (1 - fy) * g(ty, tx - 1, (ty < 7) & (tx >= 1)) +
             (1 - fx) * fy * g(ty - 1, tx, (ty >= 1) & (tx < 7)) +
             fx * fy * g(ty - 1, tx - 1, (ty >= 1) & (tx >= 1)))
        out[p] = np.where(inw, v, 0.0)
    return out


def bw_dataflow(g, f1, f2, co, kk, jj, go, tiles, cap=BW_CAP):
    """The whole design in numpy: records, frame lists, each tile's entries
    summed into its accumulator (dfmap) and into dgmap[kk] per entry.
    Returns ((dgmap, dfmap1, dfmap2) f32, per tile (box entries, pixel
    entries, pixels with a dgmap atomic, batches), (2, E) masks: box pixels
    | overflow pixels << 9)."""
    F = f1.shape[0]
    dims = (f1.shape[1:3], f2.shape[1:3])
    levels, key = bw_records(co, kk, jj, go, g.shape[0], F, dims)
    lists = bw_lists(key, F)
    dg = np.zeros((g.shape[0], 9, 128), np.float32)
    dfs = [np.zeros(f.shape, np.float32) for f in (f1, f2)]
    seen = [np.zeros(f.shape[:3], int) for f in (f1, f2)]
    gr = g.reshape(-1, 9, 128)
    stats = []
    for lvl, f, t in bw_tiles(dims, tiles, F):
        lv, fm = levels[lvl], (f1, f2)[lvl]
        x0, x1, y0, y1 = t
        seen[lvl][f, y0:y1, x0:x1] += 1
        entries, batches = bw_tile_entries(lv, lists[f], t, cap=cap)
        acc = np.zeros((y1 - y0, x1 - x0, 128), np.float32)
        n_dg = 0
        for e, code in entries:
            r, mask = _entry_rect(lv, e, code, t)
            d = _dtq(lv, go[..., lvl].reshape(len(kk), -1), e, mask, r)
            rx0, rx1, ry0, ry1 = r
            acc[ry0 - y0:ry1 - y0, rx0 - x0:rx1 - x0] += np.einsum(
                'pyx,pc->yxc', d, gr[kk[e]])
            org = lv[0][e]
            pm = mask & (org[:, 0] < rx1) & (org[:, 0] + 8 > rx0) & \
                (org[:, 1] < ry1) & (org[:, 1] + 8 > ry0)
            n_dg += int(pm.sum())
            dg[kk[e]] += np.einsum('pyx,yxc->pc', d,
                                   fm[f, ry0:ry1, rx0:rx1].astype(np.float32))
        dfs[lvl][f, y0:y1, x0:x1] = acc
        stats.append((sum(c == BOX_CODE for _, c in entries),
                      sum(c != BOX_CODE for _, c in entries), n_dg,
                      len(batches)))
    # the tiles cover each map position once: every element written once
    assert all((s == 1).all() for s in seen)
    masks = np.stack([(lv[2] * (1 << np.arange(9))).sum(1) |
                      ((lv[3] * (1 << np.arange(9))).sum(1) << 9)
                      for lv in levels])
    return (dg.reshape(g.shape), *dfs), np.array(stats), masks


def _bw_case(H, W, seed, E=240, zero_rows=True):
    """_case with some output-gradient rows zero: edges 20 .. 59 at level
    1, 40 .. 79 at level 2 (40 .. 59 at both: dropped whole)."""
    g, f1, f2, co, kk, jj, go = _case(H, W, seed, E=E)
    if zero_rows:
        go[20:60, ..., 0] = 0.0
        go[40:80, ..., 1] = 0.0
    return g, f1, f2, co, kk, jj, go


def _assert_grads(got, ref):
    for a, b in zip(got, ref):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=0)


@pytest.mark.parametrize('hw,tiles', [
    ((24, 32), ((8, 16), (8, 8))),
    ((24, 32), ((8, 8), (4, 8))),
    ((40, 36), ((16, 16), (8, 16))),
], ids=['8x16', '8x8', '16x16'])
def test_tile_dataflow_matches_plain(hw, tiles):
    """The emulated design (borders, NaN and far-off edges, zero rows,
    overflow pixels) gives corr_backward_plain's gradients."""
    c = _bw_case(*hw, seed=hw[0] + tiles[0][0])
    got, stats, masks = bw_dataflow(*c, tiles)
    _assert_grads(got, corr_backward_plain(*(torch.from_numpy(a)
                                             for a in c)))
    # both kinds of entry ran, and an edge's pixels go one way each
    assert stats[:, 0].sum() > 0 and stats[:, 1].sum() > 0
    assert not (masks & (masks >> 9) & 0x1ff).any()


def test_dropped_edges_make_no_entries():
    """Zero output-gradient rows, out-of-range kk / jj, NaN and far-off
    edges: no pixel left at that level, and an edge with none at either
    level is in no frame list."""
    g, f1, f2, co, kk, jj, go = _bw_case(24, 32, seed=3)
    kk[100], jj[101] = 6, -1                      # Ng = 6, F = 3
    dims = (f1.shape[1:3], f2.shape[1:3])
    levels, key = bw_records(co, kk, jj, go, 6, 3, dims)
    live = [lv[2].any(1) | lv[3].any(1) for lv in levels]
    assert not live[0][20:60].any() and not live[1][40:80].any()
    dead = np.r_[0:3, N_NAN:N_NAN + N_FAR, 40:60, 100, 101]
    assert (key[dead] == -1).all()
    assert sorted(np.concatenate(bw_lists(key, 3))) == \
        list(np.nonzero(key >= 0)[0])
    # the edges with all pixels NaN are dropped; one NaN pixel drops only
    # that pixel
    assert not any(lv[2][3:N_NAN, 5].any() or lv[3][3:N_NAN, 5].any()
                   for lv in levels)


def test_small_cap_splits_one_tile_into_batches():
    """Every edge on one frame and one tile, a cap of 8 entries and 4
    threads a round: the tile's entries split into many batches, in the
    same order, and the sums do not change."""
    g, f1, f2, co, kk, jj, go = _bw_case(24, 32, seed=4, E=64,
                                         zero_rows=False)
    jj[:] = 1
    co = (co - co.reshape(64, 9, 2).mean(1)[:, None, None, :] +
          np.float32([[[[9.0, 5.0]]]])).astype(np.float32)
    ref = corr_backward_plain(*(torch.from_numpy(a)
                                for a in (g, f1, f2, co, kk, jj, go)))
    dims = (f1.shape[1:3], f2.shape[1:3])
    levels, key = bw_records(co, kk, jj, go, 6, 3, dims)
    lst = bw_lists(key, 3)[1]
    t = (8, 16, 0, 8)
    full, one = bw_tile_entries(levels[0], lst, t)
    split, many = bw_tile_entries(levels[0], lst, t, cap=8, scan=1,
                                  threads=4)
    # rounds of 4 edges: a round ends at 4 edges or at the cap
    assert len(one) == 1 and len(many) > 8 and split == full
    assert all(len(b) <= 8 for b in many)
    got, _, _ = bw_dataflow(g, f1, f2, co, kk, jj, go, ((8, 16), (8, 8)),
                            cap=8)
    _assert_grads(got, ref)


def test_overflow_pixels_binned_on_their_own():
    """Wide spreads (up to 9 px, as phase 13's corr_case plants them):
    pixels outside their union box (K1's box_fits) are summed as entries of
    their own, and the sums still match plain."""
    g, f1, f2, co, kk, jj, go = _bw_case(40, 48, seed=6, E=96,
                                         zero_rows=False)
    rng = np.random.RandomState(6)
    sp = rng.uniform(0.5, 9.0, (96, 2, 1, 1)).astype(np.float32)
    off = np.linspace(-1.0, 1.0, 3, dtype=np.float32)
    ctr = co[:, 1:2, 1:2, :]
    zero = np.zeros((1, 3, 3), np.float32)
    co = np.stack([ctr[..., 0] + sp[:, 0] * off[None, None, :] + zero,
                   ctr[..., 1] + sp[:, 1] * off[None, :, None] + zero], -1)
    co = co.astype(np.float32)
    co[:3] = np.nan
    fits = corr_onepass.box_fits(torch.from_numpy(co), 40, 48, 10, 12)
    got, stats, masks = bw_dataflow(g, f1, f2, co, kk, jj, go,
                                    ((8, 16), (8, 8)))
    # an in-map pixel of a live edge is summed with its box where K1 fits it
    dims = ((40, 48), (10, 12))
    levels, _ = bw_records(co, kk, jj, go, 6, 3, dims)
    for lvl, lv in enumerate(levels):
        both = lv[2] | lv[3]
        assert np.array_equal(lv[2], both & fits[..., lvl].reshape(96, 9)
                              .numpy())
    assert stats[:, 1].sum() > 50
    _assert_grads(got, corr_backward_plain(*(torch.from_numpy(a) for a in
                                             (g, f1, f2, co, kk, jj, go))))


def test_backward_constants_match_source():
    """The emulation's constants and rules are csrc/corr_backward.cu's."""
    src = SRC.read_text()

    def const(name):
        return int(re.search(r'constexpr int ' + name + r' = ([^;]+);',
                             src).group(1).split()[0])
    assert const('kCap') == BW_CAP and const('kScan') == BW_SCAN
    assert const('kBox') == BW_BOX == corr_onepass.BOX
    assert const('kWarps') * 32 == BW_THREADS
    assert const('kBoxCode') == BOX_CODE
    assert 'constexpr int kFit = kBox - kD;' in src and BW_FIT == 12 - 8
    for line in ('const bool fit = ox - bx <= kFit && oy - by <= kFit;',
                 'const bool inmap = px && ox < W && ox + kD > 0 && '
                 'oy < H && oy + kD > 0;',
                 'if (off[u] + cnt[u] > kCap) {',
                 'pos += min(nedges - pos, min(cut, kScan * kThreads));',
                 'const int i = pos + u * kThreads + threadIdx.x;',
                 'key[e] = any ? j : -1;'):
        assert line in src, line
    # no atomic on the maps' gradients: dfmap is only stored
    assert 'atomicAdd(dfm' not in src and 'atomicAdd(out + p * kC' in src
    for dt in (torch.bfloat16, torch.float32):
        (a, b), (c, d) = corr_grad.TILES[dt]
        assert max(a * b, c * d) <= 128


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel runs only on the card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _card_case(dev, E, dtype, seed=0, H=120, W=160, F=4, Ng=64):
    g, f1, f2, co, kk, jj, go = _case(H, W, seed, E=E, F=F, Ng=Ng)
    maps = [torch.from_numpy(a).to(dev).to(dtype) for a in (g, f1, f2)]
    rest = [torch.from_numpy(a).to(dev) for a in (co, kk, jj, go)]
    return maps, rest


def _check(got, ref):
    """f32 maps: the kernels sum in another order than plain (dgmap with
    atomics, in an order that changes from run to run), 1e-5 * max|plain|;
    bf16 maps: one bf16 rounding more."""
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype or b.dtype == torch.float32
        m = b.float().abs().max().item()
        d = (a.float() - b.float()).abs()
        bound = 1e-5 * m + (2 ** -8 * b.float().abs()
                            if a.dtype == torch.bfloat16 else 0.0)
        assert bool(torch.isfinite(a).all())
        assert bool((d <= bound).all()), (d.max().item(), m)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('E', [1, 7, 131, 132, 133, 2048])
def test_kernel_matches_plain(cuda, dtype, E):
    maps, rest = _card_case(cuda, max(E, N_NAN + N_FAR + 1), dtype)
    rest = [t[-E:] for t in rest]
    before = corr_grad.backward_launches
    got = corr_backward(*maps, *rest)
    torch.cuda.synchronize()
    assert corr_grad.backward_launches == before + 1
    ref = corr_backward_plain(*maps, *rest)
    _check(got, ref)


@pytest.mark.cuda
def test_kernel_nan_and_far_edges_add_nothing(cuda):
    maps, rest = _card_case(cuda, 64, torch.float32)
    idx = torch.tensor(np.r_[0:3, N_NAN:N_NAN + N_FAR], device=cuda)
    got = corr_backward(*maps, *[t[idx] for t in rest])
    torch.cuda.synchronize()
    assert not any(bool(g.any()) for g in got)


@pytest.mark.cuda
def test_kernel_on_a_side_stream(cuda):
    maps, rest = _card_case(cuda, 512, torch.bfloat16, seed=3)
    ref = corr_backward_plain(*maps, *rest)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = corr_backward(*maps, *rest)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    _check(got, ref)


@pytest.mark.cuda
def test_train_correlation_launches_both_kernels(cuda):
    maps, (co, kk, jj, go) = _card_case(cuda, 256, torch.bfloat16, seed=4)
    maps = [m.requires_grad_(True) for m in maps]
    k1, bw = corr_onepass.launches, corr_grad.backward_launches
    out = corr_two_level_train(*maps, co, kk, jj)
    grads = torch.autograd.grad((out * go).sum(), maps)
    torch.cuda.synchronize()
    assert corr_onepass.launches == k1 + 1
    assert corr_grad.backward_launches == bw + 1
    _check(grads, corr_backward_plain(*[m.detach() for m in maps], co, kk,
                                      jj, go))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_map_gradients_bit_identical(cuda, dtype):
    """dfmap1 / dfmap2: one owner per tile, a fixed order: two launches
    give the same bits (dgmap, summed with atomics, within the bound)."""
    maps, rest = _card_case(cuda, 2048, dtype, seed=5)
    a = corr_backward(*maps, *rest)
    b = corr_backward(*maps, *rest)
    torch.cuda.synchronize()
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    _check(a, corr_backward_plain(*maps, *rest))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_kernel_with_zero_rows(cuda, dtype):
    """80% of the edges with an all-zero output gradient (the trainer's
    backward edge dropout), and some zero at one level only."""
    maps, (co, kk, jj, go) = _card_case(cuda, 2048, dtype, seed=6)
    keep = torch.from_numpy(np.random.RandomState(6).rand(2048) < 0.2)
    go = go * keep.to(cuda)[:, None, None, None, None, None]
    go[:50, ..., 1] = 0.0
    _check(corr_backward(*maps, co, kk, jj, go),
           corr_backward_plain(*maps, co, kk, jj, go))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_every_edge_on_one_tile(cuda, dtype):
    """The level-2 worst case: every edge on one frame, its windows in one
    place, so one tile per level holds all the entries in many batches."""
    maps, (co, kk, jj, go) = _card_case(cuda, 2048, dtype, seed=7)
    jj = torch.full_like(jj, 2)
    co = co - co.nan_to_num().mean((1, 2), keepdim=True) + \
        torch.tensor([20.0, 12.0], device=cuda)
    co = co.nan_to_num(0.0).contiguous()
    _check(corr_backward(*maps, co, kk, jj, go),
           corr_backward_plain(*maps, co, kk, jj, go))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_overflow_heavy_coords(cuda, dtype):
    """Spreads up to 9 px: most pixels outside their union box, each summed
    as an entry of its own."""
    maps, (co, kk, jj, go) = _card_case(cuda, 1024, dtype, seed=8)
    rng = np.random.RandomState(8)
    sp = torch.from_numpy(rng.uniform(0.5, 9.0, (1024, 1, 1, 2))
                          .astype(np.float32)).to(cuda)
    off = torch.linspace(-1.0, 1.0, 3, device=cuda)
    grid = torch.stack(torch.broadcast_tensors(off[None, :], off[:, None]),
                       -1)
    co = (co[:, 1:2, 1:2, :] + sp * grid).contiguous()
    work = corr_grad.backward_work(*maps, co, kk, jj, go)
    own = sum(int(((work['masks'] >> (9 + p)) & 1).sum()) for p in range(9))
    assert own > 1000
    _check(work['grads'], corr_backward_plain(*maps, co, kk, jj, go))


@pytest.mark.cuda
@pytest.mark.parametrize('tiles', [None, ((8, 8), (4, 8)),
                                   ((8, 16), (8, 16))],
                         ids=['default', 'small', 'wide'])
def test_work_matches_emulation(cuda, tiles):
    """The card's records and per-tile work (box entries, pixel entries,
    dgmap pixels, batches) are the numpy emulation's, and so are its
    gradients."""
    c = _bw_case(24, 32, seed=11)
    t = tiles or corr_grad.TILES[torch.float32]
    ref, stats, masks = bw_dataflow(*c, t)
    maps = [torch.from_numpy(a).to(cuda) for a in c[:3]]
    rest = [torch.from_numpy(a).to(cuda) for a in c[3:]]
    work = corr_grad.backward_work(*maps, *rest, tiles=t)
    assert np.array_equal(work['stats'].numpy(), stats)
    assert np.array_equal(work['masks'].numpy(), masks)
    _assert_grads([g.cpu().numpy() for g in work['grads']], ref)


@pytest.mark.cuda
def test_kernel_refuses(cuda):
    maps, (co, kk, jj, go) = _card_case(cuda, 32, torch.float32)
    g, f1, f2 = maps
    bad = [
        ((g.half(), f1.half(), f2.half(), co, kk, jj, go), TypeError),
        ((g, f1.bfloat16(), f2, co, kk, jj, go), TypeError),
        ((g, f1.transpose(1, 2), f2, co, kk, jj, go), ValueError),
        ((g, f1, f2, co, kk.long(), jj, go), ValueError),
        ((g, f1, f2, co, kk, jj, go.double()), ValueError),
        ((g, f1, f2, co, kk, jj, go[:, :6]), ValueError),
        ((g, f1, f2, co, kk, jj, go.cpu()), ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            corr_backward(*args)
    with pytest.raises(ValueError):      # tiles past a block's shared memory
        corr_grad.backward_work(g, f1, f2, co, kk, jj, go,
                                tiles=((16, 16), (16, 16)))
