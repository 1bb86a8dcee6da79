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

On the card (marked cuda, skipped without one): the kernel
csrc/corr_backward.cu against corr_backward_plain, for f32 and bf16 maps,
on edge counts around the grid, on a side stream, and its refusals. Run
there with `python -m pytest tests/test_torch_corr_grad.py -q`.
"""
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
    """f32 maps: the kernel sums with atomics in an order that changes from
    run to run, 1e-5 * max|plain|; bf16 maps: one bf16 rounding more."""
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
