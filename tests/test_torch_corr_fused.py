"""dpvo_torch's fused correlation (ops/corr_fused.py) against dpvo_tpu's
(ops/corr_fused.py, ops/corr_select.py) on the same numpy inputs, on the
CPU, where the port runs the plain versions of its kernels K2 (planes) and
K3 (tap select) and dpvo_tpu its Pallas kernels in interpret mode.

Cases: tests/test_corr_fused.py's (E = 96, 64x96 / 16x24 maps, interior +
borders), extreme borders, and a spread that overflows the window.

Tolerances, each with its reason:
  * window_base: the integers equal dpvo_tpu's exactly once its slab
    offsets TY / TX are removed; the fractions are bitwise equal.
  * planes: both sum 128 f32 products per plane entry, in another order,
    then round to bf16: one bf16 rounding apart, |port - tpu| <=
    2^-7 |tpu|, plus 1e-5 * max|tpu| for entries that cancel to near zero
    (there the f32 sum order shows: measured 5.2453e-05 vs 5.2929e-05).
  * select: the same f32 operations on the same bf16 planes:
    <= 1e-5 * max|tpu| (measured: bitwise equal).
  * corr_fused with dpvo_tpu's select kernel (select_kernel=True): the
    selects agree in f32, so what is left is the planes' bf16 rounding
    (one bf16 step of a plane entry can move a tap by up to 2^-8 of the
    largest entry): <= 2^-8 * max|plane| (measured: <= 2.9e-3 at
    max|tpu| = 37, most cases ~4e-6).
  * corr_fused with dpvo_tpu's XLA select (select_kernel=False on its side;
    the port has only the f32 select): that select runs its y pass in the
    planes' bf16, so the two differ by bf16 roundings of the intermediate
    rows: <= 2^-6 * max|tpu| (measured: up to 0.9% of max|tpu|).
  * below D_MIN both sides take the exact correlation: the port equals its
    own ops/corr.py bitwise and dpvo_tpu's ops/corr.py to 1e-5 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_fused as tcf
from dpvo_torch.ops.corr import corr as torch_corr
from dpvo_tpu.ops import corr_fused as jcf
from dpvo_tpu.ops.corr_select import select_taps_tpu

C = 128


def _case(E=96, H1=64, W1=96, F=4, seed=0, kind='mixed'):
    """gmap, fmap1, fmap2 (f32, bf16-representable), coords, kk, jj."""
    rng = np.random.RandomState(seed)
    gmap = rng.randn(F * 16, 3, 3, C).astype(np.float32)
    fmap1 = rng.randn(F, H1, W1, C).astype(np.float32)
    fmap2 = rng.randn(F, H1 // 4, W1 // 4, C).astype(np.float32)
    gmap, fmap1, fmap2 = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                          for a in (gmap, fmap1, fmap2))
    off = np.linspace(-1.0, 1.0, 3)
    if kind == 'mixed':           # mostly interior, some at the borders
        nb = E // 5
        cx = np.concatenate([rng.uniform(8, W1 - 9, E - nb),
                             rng.uniform(0, 4, nb)])
        cy = np.concatenate([rng.uniform(8, H1 - 9, E - nb),
                             rng.uniform(H1 - 4, H1 - 1, nb)])
        sx = off[None, None, :] + rng.uniform(-0.3, 0.3, (E, 3, 3))
        sy = off[None, :, None] + rng.uniform(-0.3, 0.3, (E, 3, 3))
    elif kind == 'extreme':       # deep negative, straddling 0 / max, far
        q = E // 4
        cx = np.concatenate([rng.uniform(-30, -10, q), rng.uniform(-2, 2, q),
                             rng.uniform(W1 - 2, W1 + 2, q),
                             rng.uniform(W1 + 10, W1 + 1e6, E - 3 * q)])
        cy = np.concatenate([rng.uniform(-1e6, -10, q), rng.uniform(-2, 2, q),
                             rng.uniform(H1 - 2, H1 + 2, q),
                             rng.uniform(H1 + 10, H1 + 30, E - 3 * q)])
        sx = np.broadcast_to(off[None, None, :], (E, 3, 3))
        sy = np.broadcast_to(off[None, :, None], (E, 3, 3))
    else:                         # 'overflow': half with a 20 px x spread
        cx = rng.uniform(14, W1 - 15, E)
        cy = rng.uniform(8, H1 - 9, E)
        wide = (np.arange(E) % 2 == 0)[:, None, None]
        sx = np.broadcast_to(np.where(wide, 10 * off[None, None, :],
                                      2.5 * off[None, None, :]), (E, 3, 3))
        sy = np.broadcast_to(2 * off[None, :, None], (E, 3, 3))
    coords = np.stack([cx[:, None, None] + sx, cy[:, None, None] + sy],
                      -1).astype(np.float32)
    kk = rng.randint(0, F * 16, E).astype(np.int32)
    jj = np.sort(rng.randint(0, F, E)).astype(np.int32)
    return gmap, fmap1, fmap2, coords, kk, jj


def _jax_planes(gmap, fmap1, fmap2, coords, kk, jj):
    """dpvo_tpu's planes, fed the pa / pb its corr_fused builds
    (ops/corr_fused.py:316-351)."""
    E = coords.shape[0]
    H1, W1 = fmap1.shape[1:3]
    H2, W2 = fmap2.shape[1:3]
    co = jnp.asarray(coords)
    *_, by1, bx1, _, _ = jcf._window_base(co, H1, W1, 3)
    *_, by2, bx2, _, _ = jcf._window_base(co / 4.0, H2, W2, 3, align=4)
    ph2 = (bx2 // 4) % 2
    pa = jnp.asarray(jj) | (by1 << 8) | ((bx1 // 8) << 18)
    pb = by2 | (((bx2 - 4 * ph2) // 8) << 10) | (ph2 << 18)
    g9 = jnp.asarray(gmap, jnp.bfloat16)[kk].reshape(E, 9, C)
    fp1 = jcf.pad_slab(jnp.asarray(fmap1, jnp.bfloat16))
    fp2 = jcf.pad_slab2(jnp.asarray(fmap2, jnp.bfloat16))
    p1, p2 = jcf._planes_fused(g9, fp1, fp2, pa, pb, interpret=True)
    return (np.asarray(p1, np.float32).reshape(E, 9, jcf.WY, jcf.WX),
            np.asarray(p2, np.float32).reshape(E, 9, jcf.WY2, jcf.WX2))


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bf16(*arrays):
    return [t.to(torch.bfloat16) for t in _torch(*arrays)]


@pytest.mark.parametrize('level', [1, 2])
@pytest.mark.parametrize('kind', ['mixed', 'extreme', 'overflow'])
def test_window_base_matches_jax(level, kind):
    *_, coords, _, _ = _case(kind=kind)
    H, W, align = (64, 96, 8) if level == 1 else (16, 24, 4)
    scale = 1.0 if level == 1 else 4.0
    ref = jcf._window_base(jnp.asarray(coords) / scale, H, W, 3, align=align)
    got = tcf.window_base(torch.from_numpy(coords) / scale, H, W, align)
    names = ('xi', 'yi', 'fx', 'fy', 'by', 'bx', 'oy', 'ox')
    slab = {'by': jcf.TY, 'bx': jcf.TX}
    for name, r, g in zip(names, ref, got):
        r = np.asarray(r) - slab.get(name, 0)
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


@pytest.mark.parametrize('kind', ['mixed', 'extreme', 'overflow'])
def test_planes_plain_matches_jax(kind):
    gmap, fmap1, fmap2, coords, kk, jj = _case(kind=kind)
    ref1, ref2 = _jax_planes(gmap, fmap1, fmap2, coords, kk, jj)
    co, kk_t, jj_t = _torch(coords, kk, jj)
    *_, by1, bx1, _, _ = tcf.window_base(co, 64, 96, 8)
    *_, by2, bx2, _, _ = tcf.window_base(co / 4.0, 16, 24, 4)
    g, f1, f2 = _bf16(gmap, fmap1, fmap2)
    got1, got2 = tcf.planes_plain(g.reshape(-1, 9, C), f1, f2, kk_t, jj_t,
                                  by1, bx1, by2, bx2)
    assert got1.dtype == got2.dtype == torch.bfloat16
    for got, ref in ((got1, ref1), (got2, ref2)):
        err = np.abs(got.float().numpy() - ref)
        bound = 2 ** -7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
        assert (err <= bound).all(), err.max()
        assert np.abs(ref).max() > 0


@pytest.mark.parametrize('level', [1, 2])
def test_select_plain_matches_jax(level):
    """At both window shapes, over interior, borders and pixels whose block
    overflows the window."""
    rng = np.random.RandomState(11 + level)
    E = 70                                # not a multiple of dpvo_tpu's EBS
    H, W, align, wy, wx = ((64, 96, 8, jcf.WY, jcf.WX) if level == 1 else
                           (16, 24, 4, jcf.WY2, jcf.WX2))
    plane = np.asarray(jnp.asarray(rng.randn(E, 9, wy, wx), jnp.bfloat16),
                       np.float32)
    cx = np.concatenate([rng.uniform(4, W - 5, E - 20),
                         rng.uniform(-3, 3, 10), rng.uniform(W - 3, W + 3, 10)])
    cy = rng.uniform(-2, H + 2, E)
    spread = np.where(np.arange(E) % 7 == 0, 7.0, 1.2)[:, None, None]
    off = np.linspace(-1.0, 1.0, 3)
    gx = cx[:, None, None] + spread * off[None, None, :] + \
        rng.uniform(-0.5, 0.5, (E, 3, 3))
    gy = cy[:, None, None] + spread * off[None, :, None] + \
        rng.uniform(-0.5, 0.5, (E, 3, 3))
    coords = np.stack([gx, gy], -1).astype(np.float32)
    xi, yi, fx, fy, _, _, oy, ox = jcf._window_base(
        jnp.asarray(coords), H, W, 3, align=align)
    assert int(jnp.max(ox)) > wx - 8          # some blocks overflow
    ref = np.asarray(select_taps_tpu(jnp.asarray(plane, jnp.bfloat16), yi, xi,
                                     fy, fx, oy, ox, H=H, W=W, radius=3,
                                     interpret=True))
    got = tcf.select_plain(torch.from_numpy(plane).to(torch.bfloat16),
                           *_torch(yi, xi, fy, fx, oy, ox), H, W)
    assert got.shape == (E, 7, 7, 3, 3) and got.dtype == torch.float32
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)


def _both(kind, select_kernel):
    gmap, fmap1, fmap2, coords, kk, jj = _case(kind=kind)
    g, f1, f2 = (jnp.asarray(a, jnp.bfloat16) for a in (gmap, fmap1, fmap2))
    ref = jcf.corr_fused(g, f1, f2, jnp.asarray(coords), jnp.asarray(kk),
                         jnp.asarray(jj), interpret=True,
                         select_kernel=select_kernel)
    before = (tcf.plane_launches, tcf.select_launches)
    got = tcf.corr_fused(*_bf16(gmap, fmap1, fmap2), *_torch(coords, kk, jj))
    # on the CPU the wrappers run the plain versions: no launch
    assert (tcf.plane_launches, tcf.select_launches) == before
    planes = _jax_planes(gmap, fmap1, fmap2, coords, kk, jj)
    return ([np.asarray(r) for r in ref], [t.numpy() for t in got],
            [np.abs(p).max() for p in planes])


@pytest.mark.parametrize('kind', ['mixed', 'extreme', 'overflow'])
def test_corr_fused_matches_jax_select_kernel(kind):
    ref, got, pmax = _both(kind, select_kernel=True)
    for r, g, pm in zip(ref, got, pmax):
        assert g.shape == r.shape == (96, 7, 7, 3, 3)
        np.testing.assert_allclose(g, r, rtol=0, atol=2 ** -8 * pm)
    if kind == 'overflow':
        # even edges: the right patch column overflows the level-1 window
        assert np.abs(got[0][0::2, ..., 2]).max() == 0.0
        assert np.abs(got[0][0::2, ..., :2]).max() > 0.0
        assert np.abs(got[0][1::2]).max() > 0.0
    if kind == 'extreme':
        q = 96 // 4
        assert np.abs(got[0][:q]).max() == 0.0      # all taps off the map
        assert np.abs(got[0][-q:]).max() == 0.0


def test_corr_fused_matches_jax_xla_select():
    """dpvo_tpu's default select off the TPU is the XLA one (bf16 y pass);
    measured max |port - tpu| 0.33 at max|tpu| = 37 on this case."""
    ref, got, _ = _both('mixed', select_kernel=False)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=2 ** -6 *
                                   np.abs(r).max())


def test_corr_fused_small_map_fallback_exact():
    """Maps below D_MIN take the exact correlation (ops/corr.py) on both
    sides; the port's equals its own plain correlation bitwise."""
    gmap, fmap1, fmap2, coords, kk, jj = _case(E=16, H1=32, W1=48, F=2)
    g, f1, f2 = _bf16(gmap, fmap1, fmap2)
    co, kk_t, jj_t = _torch(coords, kk, jj)
    c1, c2 = tcf.corr_fused(g, f1, f2, co, kk_t, jj_t)
    assert torch.equal(c1, torch_corr(g, f1, co, kk_t, jj_t))
    assert torch.equal(c2, torch_corr(g, f2, co / 4.0, kk_t, jj_t))
    r1, r2 = jcf.corr_fused(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (gmap, fmap1, fmap2)),
                            jnp.asarray(coords), jnp.asarray(kk),
                            jnp.asarray(jj))
    for r, c in ((r1, c1), (r2, c2)):
        r = np.asarray(r)
        np.testing.assert_allclose(c.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
