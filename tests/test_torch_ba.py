"""dpvo_torch.ba_pairs.bundle_adjust_pairs against dpvo_tpu's on the same
seeded pair-blocked problem, plus the NaN guard and the depth clamps.

Tolerance: two Gauss-Newton steps through a 6W x 6W Cholesky solve, both in
f32 with sums in another order. On these problems each f32 side lies within
~4e-5 (poses) and ~2.5e-4 (inverse depths, which move by ~0.4) of a float64
run of the same code, so the sides are held to atol 2e-4 on poses and 1e-3
on depths."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ba_pairs import bundle_adjust_pairs as ba_torch
from dpvo_tpu import lie
from dpvo_tpu.ba_pairs import bundle_adjust_pairs as ba_jax

M, NF, GP = 4, 8, 16
W, PCF = 5, 6
POSE_TOL, DEPTH_TOL = 2e-4, 1e-3


def _problem(seed=0, far_depth=False):
    """A well-posed scene: ground-truth poses and inverse depths, targets at
    the true reprojections (+0.1 px noise), the solve started from poses and
    depths perturbed away from the truth. Pairs (i, j) lie within 2 frames
    and some are invalid. far_depth: a few patches sit past the d > 20
    clamp."""
    rng = np.random.RandomState(seed)
    gt = np.asarray(lie.se3_exp(jnp.asarray(
        rng.randn(NF, 6).astype(np.float32) * 0.05)))
    centers = rng.uniform(20, 100, (NF, 2 * M)).astype(np.float32)
    d_gt = rng.uniform(0.4, 1.2, NF * M).astype(np.float32)
    if far_depth:
        d_gt[M + 1::7] = 25.0
    pi = rng.randint(0, NF - 1, GP)
    pj = np.clip(pi + rng.randint(-2, 3, GP), 0, NF - 1)
    pv = rng.rand(GP) < 0.85
    intr = np.array([100.0, 100.0, 64.0, 48.0], np.float32)

    c = centers.reshape(NF, M, 2)[pi]
    X = np.stack([(c[..., 0] - 64.0) / 100.0, (c[..., 1] - 48.0) / 100.0,
                  np.ones((GP, M)), d_gt.reshape(NF, M)[pi]], -1)
    Gij = lie.se3_mul(jnp.asarray(gt[pj]), lie.se3_inv(jnp.asarray(gt[pi])))
    X1 = np.asarray(lie.se3_act4(Gij[:, None], jnp.asarray(X, jnp.float32)))
    target = np.stack([100.0 * X1[..., 0] / X1[..., 2] + 64.0,
                       100.0 * X1[..., 1] / X1[..., 2] + 48.0], -1)
    target = (target + rng.randn(GP, M, 2) * 0.1).astype(np.float32)

    poses = np.asarray(lie.se3_mul(lie.se3_exp(jnp.asarray(
        rng.randn(NF, 6).astype(np.float32) * 0.01)), jnp.asarray(gt)))
    depth = np.where(d_gt > 20, 19.9,
                     d_gt + rng.uniform(-0.05, 0.05, NF * M)
                     ).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, (GP, M, 2)).astype(np.float32)
    return dict(poses=poses, centers=centers, depth=depth, pi=pi, pj=pj,
                pv=pv, target=target, weight=weight, intr=intr)


def _run_both(p, t0, t1, fbase, scalars=False):
    """Both packages on problem p; with scalars, the port takes t0, t1 and
    fbase as 0-d int64 tensors, as its runtime passes them."""
    names = ('poses', 'centers', 'depth', 'intr', 'target', 'weight')
    bounds = ([torch.tensor(b) for b in (t0, t1, fbase)] if scalars
              else [t0, t1, fbase])
    jr = ba_jax(*(jnp.asarray(p[k]) for k in names), 1e-4,
                jnp.asarray(p['pi'], jnp.int32), jnp.asarray(p['pj'], jnp.int32),
                jnp.asarray(p['pv']), jnp.int32(t0), jnp.int32(t1),
                jnp.int32(fbase), M=M, W=W, PCF=PCF, iterations=2)
    tr = ba_torch(*(torch.tensor(p[k]) for k in names), 1e-4,
                  torch.from_numpy(p['pi']), torch.from_numpy(p['pj']),
                  torch.from_numpy(p['pv']), *bounds,
                  M=M, W=W, PCF=PCF, iterations=2)
    return [np.asarray(a) for a in jr], [a.numpy() for a in tr]


@pytest.mark.parametrize('t0, t1, fbase', [(1, 8, 0), (3, 8, 2), (1, 4, 0)])
def test_matches_jax(t0, t1, fbase):
    p = _problem()
    (jp, jd), (tp, td) = _run_both(p, t0, t1, fbase)
    assert np.abs(jp - p['poses']).max() > 1e-3   # the solve moved
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)


@pytest.mark.parametrize('t0, t1, fbase', [
    (1, 8, 0), (3, 8, 2), (0, 3, 0), (5, 8, 4), (6, 8, 7)])
def test_device_scalar_windows_match_jax(t0, t1, fbase):
    """The window bounds as device scalars: the pose window a gather of
    W rows, retracted where live and written back, the depth window the
    same over PC patches. Windows at the buffer's start (t0 = fbase = 0)
    and past its end: t0 + W beyond the NF = 8 poses, and fbase M + PC
    beyond the NF M depths, where dpvo_tpu's dynamic_slice moves the depth
    window back into the buffer. Host ints give the same result."""
    p = _problem()
    (jp, jd), (tp, td) = _run_both(p, t0, t1, fbase, scalars=True)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    live = np.arange(NF)
    live = (live >= t0) & (live < min(t0 + W, t1))
    np.testing.assert_array_equal(tp[~live], p['poses'][~live])
    assert np.abs(tp[live] - p['poses'][live]).max() > 1e-4
    _, (hp, hd) = _run_both(p, t0, t1, fbase)
    np.testing.assert_array_equal(hp, tp)
    np.testing.assert_array_equal(hd, td)


def test_nan_target_zero_update():
    """A NaN residual makes the step non-finite: the guard zeroes it, so
    poses stay exactly as they were (dpvo_tpu regression test twin)."""
    p = _problem()
    p['target'][:] = np.nan
    (jp, jd), (tp, td) = _run_both(p, 1, NF, 0)
    np.testing.assert_array_equal(tp, p['poses'])
    np.testing.assert_array_equal(tp, jp)
    assert np.isfinite(td).all()


def test_depth_clamps_match():
    """Patches whose solve goes past d > 20 are reset to 1 on both sides."""
    p = _problem(seed=2, far_depth=True)
    (jp, jd), (tp, td) = _run_both(p, 1, NF, 0)
    assert np.any(td == 1.0)
    np.testing.assert_allclose(td, jd, atol=DEPTH_TOL, rtol=0)
    np.testing.assert_allclose(tp, jp, atol=POSE_TOL, rtol=0)
