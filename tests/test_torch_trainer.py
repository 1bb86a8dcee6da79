"""dpvo_torch's training stack (dpvo_torch/train/) against dpvo_tpu's, on the
CPU, on the same seeded numpy inputs and weights.

- grad_clip / grad_zero: the backward against the JAX custom_vjps, exactly.
- edge_schedule / _group_ids array-equal; make_batch bit-equal.
- se3_scale, and the gradients of so3_log, se3_log and
  _so3_left_jacobian_inv off the identity against jax.grad: 1e-5 * max.
- bundle_adjust_train, with and without structure_only: outputs at 1e-4 in
  f32. The VJP (w.r.t. target and weight) at 1e-4 * max|VJP| in f64, where
  both compute the same math to ~1e-13; in f32 at 5e-3 * max|VJP|: one
  Gauss-Newton step of this window amplifies f32 rounding (measured against
  dpvo_tpu's f64 VJP: its own f32 VJP lies 1.8e-4 / 1.4e-3 * max off for
  target / weight, the port's 5.3e-4 / 2.5e-3). On a
  non-positive-definite window both give the zero update; dpvo_tpu's VJP
  is NaN there, the port's zero (the reference's CholeskySolver posture).
- vonet_forward + trajectory_loss on tests/test_trainer.py:_tiny_batch
  (T = 8, M = 2, 32x32, edge_schedule(8, 2, 2), f32, seeded init weights):
  the loss within 1e-5 relative, every parameter's gradient within 1e-3
  relative L2 of jax.value_and_grad's (over parameters whose JAX gradient
  norm exceeds 1e-6 of the global norm); trajectory_loss's pose branch
  (steps >= 2, which that unroll does not reach) on its own: 1e-5.
- The optimizer: the one-cycle rate and three steps of clip + AdamW
  against optax on the same gradients: 1e-6.
- Ports of test_trainer.py's smoke test and dropout test; the mixed
  precision step; the .npz round trip into dpvo_tpu.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpvo_torch import lie as tl
from dpvo_torch.data_readers import synthetic as tsyn
from dpvo_torch.models.blocks import grad_clip, grad_zero
from dpvo_torch.models.checkpoint import (init_vonet_params,
                                          jax_from_state_dict,
                                          load_network, save_params_npz,
                                          state_dict_from_jax)
from dpvo_torch.models.vonet import init_vonet
from dpvo_torch.train import trainer as tt
from dpvo_torch.train.ba import bundle_adjust_train as ba_torch
from dpvo_tpu import lie as jl
from dpvo_tpu.data_readers import synthetic as jsyn
from dpvo_tpu.models import blocks as jblocks
from dpvo_tpu.models.checkpoint import load_params_npz
from dpvo_tpu.models.vonet import VONetParams
from dpvo_tpu.train import trainer as jt
from dpvo_tpu.train.ba import bundle_adjust_train as ba_jax
from test_torch_ba_edges import M as BA_M, NF as BA_NF, _problem
from test_torch_runtime import one_torch_thread  # noqa: F401
from test_trainer import _tiny_batch

pytestmark = pytest.mark.usefixtures('one_torch_thread')

SCHED = jt.edge_schedule(8, 2, 2)


def _np(x):
    return np.asarray(x.detach().cpu() if torch.is_tensor(x) else x)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_grad_clip_and_grad_zero_match_jax():
    rng = np.random.RandomState(0)
    g = (rng.randn(512) * 0.1).astype(np.float32)
    g[:8] = [np.nan, 0.01, -0.01, 0.1, -0.1, 0.0100001, 0.1000001, -0.2]
    for tf, jf in ((grad_clip, jblocks.grad_clip),
                   (grad_zero, jblocks.grad_zero)):
        x = torch.zeros(512, requires_grad=True)
        y = tf(x)
        assert torch.equal(y, x)
        y.backward(torch.from_numpy(g))
        ref = jax.vjp(jf, jnp.zeros(512))[1](jnp.asarray(g))[0]
        assert np.array_equal(x.grad.numpy(), np.asarray(ref))


@pytest.mark.parametrize('T, M, steps', [(10, 4, 12), (15, 80, 18)])
def test_edge_schedule_and_group_ids(T, M, steps):
    a, b = tt.edge_schedule(T, M, steps), jt.edge_schedule(T, M, steps)
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert sa[3:] == sb[3:]
        for x, y in zip(sa[:3], sb[:3]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for s in (0, steps - 1):
        for x, y in zip(tt._group_ids(*a[s][:3]), jt._group_ids(*b[s][:3])):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_make_batch_bit_equal():
    a = tsyn.make_batch([3, 4], T=10, M=4)
    b = jsyn.make_batch([3, 4], T=10, M=4)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    seqs = [tsyn.make_sequence(5, T=9, loop=True)]
    a = tsyn.make_batch_from(seqs, np.random.RandomState(1), 3)
    b = jsyn.make_batch_from(seqs, np.random.RandomState(1), 3)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('scale', [0.05, 0.7])
def test_lie_gradients_off_identity(scale):
    rng = np.random.RandomState(int(scale * 100))
    X = np.asarray(jl.se3_exp(jnp.asarray(
        rng.randn(16, 6).astype(np.float32) * scale)))
    c = rng.randn(16, 6).astype(np.float32)
    s = np.float32(1.7)
    np.testing.assert_array_equal(
        tl.se3_scale(torch.tensor(X), s).numpy(),
        np.asarray(jl.se3_scale(jnp.asarray(X), s)))
    phi = rng.randn(16, 3).astype(np.float32) * scale
    cases = [
        (tl.so3_log, jl.so3_log, X[:, 3:7], c[:, 3:6]),
        (tl.se3_log, jl.se3_log, X, c),
        (tl._so3_left_jacobian_inv, jl._so3_left_jacobian_inv, phi,
         rng.randn(16, 3, 3).astype(np.float32)),
        (lambda x: tl.se3_log(tl.se3_scale(x, 0.6)),
         lambda x: jl.se3_log(jl.se3_scale(x, 0.6)), X, c),
    ]
    for tf, jf, x, ct in cases:
        xt = torch.tensor(x, requires_grad=True)
        (tf(xt) * torch.from_numpy(ct)).sum().backward()
        ref = np.asarray(jax.grad(lambda v: jnp.sum(jf(v) * ct))(
            jnp.asarray(x)))
        assert bool(torch.isfinite(xt.grad).all())
        np.testing.assert_allclose(xt.grad.numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_kabsch_scale():
    rng = np.random.RandomState(0)
    A = torch.from_numpy(rng.randn(20, 3).astype(np.float32))
    s = float(tt.kabsch_umeyama_scale(A, A * 0.25))
    np.testing.assert_allclose(s, 4.0, rtol=1e-4)


def test_trajectory_loss_zero_when_exact():
    T = 6
    poses_gt = tl.se3_exp(torch.from_numpy(
        np.random.RandomState(0).randn(T, 6).astype(np.float32) * 0.1))
    E, P = 10, 3
    co = torch.from_numpy(
        np.random.RandomState(1).rand(E, P, P, 2).astype(np.float32))
    traj = [(torch.ones(E, dtype=torch.bool), torch.ones(E, P, P), co, co,
             poses_gt, T)] * 3
    loss, aux = tt.trajectory_loss(traj, poses_gt)
    assert float(loss) < 1e-5 and set(aux) == {'tr', 'ro'}


def test_trajectory_loss_grads_match_jax():
    """Three steps, so the pose branch (i >= 2) runs; ii == jj self-edges
    with an exactly zero residual, invalid pixels, an edge with no valid
    pixel, unsupervised edges."""
    rng = np.random.RandomState(3)
    T, E = 6, 24
    gt = np.asarray(jl.se3_exp(jnp.asarray(
        rng.randn(T, 6).astype(np.float32) * 0.2)))
    steps = []
    for _ in range(3):
        Gs = np.asarray(jl.se3_mul(jl.se3_exp(jnp.asarray(
            rng.randn(T, 6).astype(np.float32) * 0.05)), jnp.asarray(gt)))
        co_gt = rng.uniform(0, 30, (E, 3, 3, 2)).astype(np.float32)
        co = (co_gt + rng.randn(E, 3, 3, 2) * 0.5).astype(np.float32)
        co[:4] = co_gt[:4]                         # self-edges: exactly 0
        valid = (rng.rand(E, 3, 3) > 0.2).astype(np.float32)
        valid[5] = 0.0
        sup = rng.rand(E) > 0.3
        steps.append((sup, valid, co, co_gt, Gs))

    def jloss(cos, gss):
        traj = [(jnp.asarray(s[0]), jnp.asarray(s[1]), c, jnp.asarray(s[3]),
                 g, T) for s, c, g in zip(steps, cos, gss)]
        return jt.trajectory_loss(traj, jnp.asarray(gt))[0]
    args = ([jnp.asarray(s[2]) for s in steps],
            [jnp.asarray(s[4]) for s in steps])
    lj, gj = jax.value_and_grad(jloss, argnums=(0, 1))(*args)
    cos = [torch.tensor(s[2], requires_grad=True) for s in steps]
    gss = [torch.tensor(s[4], requires_grad=True) for s in steps]
    traj = [(torch.from_numpy(s[0]), torch.from_numpy(s[1]), c,
             torch.from_numpy(s[3]), g, T) for s, c, g in zip(steps, cos, gss)]
    lt, aux = tt.trajectory_loss(traj, torch.from_numpy(gt))
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert gss[0].grad is None and not np.asarray(gj[1][0]).any()
    for t, j in zip(cos + gss[2:], list(gj[0]) + list(gj[1][2:])):
        j = np.asarray(j)
        assert bool(torch.isfinite(t.grad).all())
        np.testing.assert_allclose(t.grad.numpy(), j,
                                   atol=1e-5 * np.abs(j).max(), rtol=0)


# ---------------------------------------------------------------------------
# the training BA
# ---------------------------------------------------------------------------

BA_BOUNDS = np.array([-64.0, -64.0, 128.0 + 64.0, 96.0 + 64.0], np.float32)


def _ba_both(p, structure_only, wscale=1.0, f64=False):
    """Outputs and VJPs (random cotangents on poses and depth) of one step
    of both packages, f32 or f64."""
    ndt, tdt = (np.float64, torch.float64) if f64 else \
        (np.float32, torch.float32)
    data = [p[k].astype(ndt) for k in ('poses', 'xy', 'depth', 'intr')]
    target = p['target'].astype(ndt)
    weight = (p['weight'] * wscale).astype(ndt)
    rng = np.random.RandomState(1)
    cp = rng.randn(*p['poses'].shape).astype(ndt)
    cd = rng.randn(*p['depth'].shape).astype(ndt)
    kw = dict(W=BA_NF - 1, PC=BA_NF * BA_M, fixedp=1,
              structure_only=structure_only)
    with jax.enable_x64(f64):
        def fj(t, w):
            return ba_jax(*(jnp.asarray(a) for a in data), t, w,
                          *(jnp.asarray(p[k]) for k in ('ii', 'jj', 'kk')),
                          jnp.asarray(BA_BOUNDS.astype(ndt)), **kw)
        jout, vjp = jax.vjp(fj, jnp.asarray(target), jnp.asarray(weight))
        jg = vjp((jnp.asarray(cp), jnp.asarray(cd)))
        jout = [np.asarray(a) for a in jout]
        jg = [np.asarray(a) for a in jg]
    t = torch.tensor(target, requires_grad=True)
    w = torch.tensor(weight, requires_grad=True)
    tout = ba_torch(*(torch.from_numpy(a) for a in data), t, w,
                    *(torch.from_numpy(p[k]).long() for k in ('ii', 'jj',
                                                             'kk')),
                    torch.from_numpy(BA_BOUNDS).to(tdt), **kw)
    assert all(a.dtype == tdt for a in tout)
    tg = torch.autograd.grad((tout[0] * torch.from_numpy(cp)).sum() +
                             (tout[1] * torch.from_numpy(cd)).sum(), (t, w))
    return [_np(a) for a in tout], [_np(a) for a in tg], jout, jg


@pytest.mark.parametrize('structure_only', [False, True],
                         ids=['full', 'structure_only'])
def test_bundle_adjust_train_matches_jax(structure_only):
    p = _problem()
    tout, tg, jout, jg = _ba_both(p, structure_only)
    if not structure_only:
        assert np.abs(jout[0] - p['poses']).max() > 1e-3    # the step moved
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(tg, jg):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=5e-3 * np.abs(b).max(), rtol=0)
    tout, tg, jout, jg = _ba_both(p, structure_only, f64=True)
    for a, b in zip(tout + tg, jout + jg):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max(), rtol=0)


def test_bundle_adjust_train_non_pd_window():
    """Negative weights make the damped Schur system indefinite: a zero
    update in both (depth only clamped); dpvo_tpu's VJP is NaN (its NaN
    factor meets the zero cotangent), the port's is zero."""
    p = _problem()
    tout, tg, jout, jg = _ba_both(p, False, wscale=-50.0)
    np.testing.assert_array_equal(jout[0], p['poses'])
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    assert all(np.isnan(b).all() for b in jg)
    assert all(not a.any() for a in tg)


# ---------------------------------------------------------------------------
# the whole unroll, the optimizer and the step
# ---------------------------------------------------------------------------

def _tiny():
    b = {k: np.array(v) for k, v in _tiny_batch().items()}
    return b, [torch.from_numpy(b[k][0]) for k in tt.SEQ_KEYS]


@pytest.fixture(scope='module')
def jax_loss_grads():
    """dpvo_tpu's loss and parameter gradients on the tiny batch (f32)."""
    b = _tiny_batch()
    args = [b[k][0] for k in tt.SEQ_KEYS]
    params = {k: jnp.asarray(v) for k, v in init_vonet_params(0).items()}

    def f(p):
        pp = VONetParams(f32=p, bf16={k: v.astype(jnp.bfloat16)
                                      for k, v in p.items()})
        traj = jt.vonet_forward(pp, *args, SCHED, mixed_precision=False)
        return jt.trajectory_loss(traj, b['poses_gt'][0])[0]
    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def test_vonet_forward_matches_jax(jax_loss_grads):
    loss_j, grads_j = jax_loss_grads
    _, args = _tiny()
    net = init_vonet(None, 'cpu')
    traj = tt.vonet_forward(net, *args, SCHED)
    loss, _ = tt.trajectory_loss(traj, args[1])
    loss.backward()
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    grads = jax_from_state_dict({k: p.grad for k, p in
                                 net.named_parameters()})
    assert sorted(grads) == sorted(grads_j)
    gnorm = np.sqrt(sum(float((g ** 2).sum()) for g in grads_j.values()))
    held = 0
    for k, ref in grads_j.items():
        assert np.isfinite(grads[k]).all(), k
        n = np.linalg.norm(ref)
        if n > 1e-6 * gnorm:
            held += 1
            assert np.linalg.norm(grads[k] - ref) <= 1e-3 * n, k
    assert held > 0.8 * len(grads_j)


def test_patchify_frames_is_patchify_frame_per_frame():
    _, args = _tiny()
    net = init_vonet(None, 'cpu')
    img = 2.0 * (args[0] / 255.0) - 0.5
    with torch.no_grad():
        both = net.patchify_frames(img[:3], args[4][:3])
        for t in range(3):
            one = net.patchify_frame(img[t], args[4][t])
            for k, v in one.items():
                torch.testing.assert_close(both[k][t], v, atol=1e-5,
                                           rtol=0)


@pytest.mark.parametrize('total', [100, 1000, 240000])
def test_onecycle_matches_optax(total):
    ref = optax.linear_onecycle_schedule(
        transition_steps=total, peak_value=3e-4, pct_start=0.01,
        pct_final=0.99, div_factor=25.0, final_div_factor=1e4)
    steps = sorted({0, 1, 2, total // 100, total // 100 + 1, total // 2,
                    total - 2, total - 1, total, total + 5})
    for s in steps:
        np.testing.assert_allclose(tt.onecycle_lr(s, total, 3e-4),
                                   float(ref(s)), rtol=1e-6)
    with pytest.raises(ValueError):
        tt.onecycle_lr(0, 99, 3e-4)


@pytest.mark.parametrize('gscale', [1.0, 1e4], ids=['unclipped', 'clipped'])
def test_optimizer_steps_match_optax(jax_loss_grads, gscale):
    """Three steps of clip + AdamW + one-cycle on dpvo_tpu's gradients
    (scaled so that the global norm is below / above the clip of 10)."""
    _, grads_j = jax_loss_grads
    grads_j = {k: v * np.float32(gscale) for k, v in grads_j.items()}
    gnorm = np.sqrt(sum(float((g ** 2).sum()) for g in grads_j.values()))
    assert (gnorm > 10.0) == (gscale > 1.0)
    params = {k: jnp.asarray(v) for k, v in init_vonet_params(0).items()}
    opt = jt.make_optimizer(lr=1e-3, total_steps=100)
    state = opt.init(params)
    net = init_vonet(None, 'cpu')
    topt = tt.make_optimizer(net.parameters(), lr=1e-3, total_steps=100)
    tgrads = state_dict_from_jax(grads_j)
    for _ in range(3):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in
                                 grads_j.items()}, state, params)
        params = optax.apply_updates(params, upd)
        for k, p in net.named_parameters():
            p.grad = tgrads[k].clone()
        topt.step()
    got = jax_from_state_dict(net.state_dict())
    for k, v in params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), atol=1e-6,
                                   rtol=0, err_msg=k)


def test_train_step_smoke_loss_decreases():
    """Port of test_trainer.py's smoke test: finite losses that the
    optimizer pushes below the start (min over the run: the loss surface
    is nonconvex)."""
    b, _ = _tiny()
    net = init_vonet(None, 'cpu')
    opt = tt.make_optimizer(net.parameters(), lr=1e-3, total_steps=100)
    step = tt.make_train_step(net, opt, SCHED, structure_only=False,
                              mixed_precision=False)
    losses = [float(step(b)[0]) for _ in range(6)]
    assert all(np.isfinite(v) for v in losses), losses
    assert min(losses[1:]) < losses[0], losses


def test_dropout_masks_alter_gradients():
    """Port of test_trainer.py's dropout test: corr-gradient dropout leaves
    the (edge-dropout-free) forward loss as it is and changes the
    gradients, the patchify.fnet ones among them."""
    _, args = _tiny()

    def loss_with(rng, keep):
        net = init_vonet(None, 'cpu')
        traj = tt.vonet_forward(net, *args, SCHED, rng=rng,
                                corr_grad_keep=keep, edge_dropout=0.0)
        loss = tt.trajectory_loss(traj, args[1])[0]
        loss.backward()
        return float(loss), {k: p.grad.clone()
                             for k, p in net.named_parameters()}

    l_plain, g_plain = loss_with(None, 1.0)
    l_drop, g_drop = loss_with(np.array([0, 7], np.uint32), 0.2)
    np.testing.assert_allclose(l_plain, l_drop, rtol=1e-5)
    diffs = {k: (g_plain[k] - g_drop[k]).abs().max().item() for k in g_plain}
    assert max(diffs.values()) > 0
    assert any(v > 0 for k, v in diffs.items()
               if k.startswith('patchify.fnet'))


def test_mixed_precision_step_lands_on_f32_masters():
    """Under mixed precision the unroll runs on bf16 copies made inside the
    step (torch.func.functional_call): the f32 masters get finite f32
    gradients, and the loss is the f32 run's within bf16 rounding."""
    b, args = _tiny()
    net = init_vonet(None, 'cpu')
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    seen = {}

    class Spy(tt.Optimizer):
        def step(self):
            seen.update({k: p.grad for k, p in net.named_parameters()})
            super().step()

    opt = Spy(net.parameters(), 1e-3, 100, 10.0)
    step = tt.make_train_step(net, opt, SCHED, mixed_precision=True)
    loss, _ = step(b)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(g is not None and g.dtype == torch.float32 and
               bool(torch.isfinite(g).all()) for g in seen.values())
    assert any(not torch.equal(p, before[k])
               for k, p in net.named_parameters())
    net32 = init_vonet(None, 'cpu')
    with torch.no_grad():
        l32 = tt.trajectory_loss(tt.vonet_forward(net32, *args, SCHED),
                                 args[1])[0]
    np.testing.assert_allclose(float(loss), float(l32), rtol=0.05)


def test_save_params_npz_round_trip(tmp_path):
    """Weights saved by the port load in dpvo_tpu, exactly, and back."""
    ref = init_vonet_params(0)
    net = init_vonet(None, 'cpu')
    path = str(tmp_path / 'w.npz')
    save_params_npz(net.state_dict(), path)
    back = load_params_npz(path)
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert back[k].dtype == np.float32 and np.array_equal(back[k],
                                                              ref[k]), k
    sd = load_network(path)
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
