"""The classic loop closure's numerics on the port against dpvo_tpu, on the
same numpy inputs, on the CPU (torch on one thread):

* Sim3 and RxSO3 exp / log / inv / mul / act (dpvo_torch/lie.py) within
  1e-5, at random tangents and at theta < 1e-4, unit scale and the
  identity; the PGO's residual Jacobians (torch.func.jacfwd) against
  jax.jacfwd's within 1e-4 relative, with no NaN at the identity;
* perform_updates and run_DPVO_PGO (loop_closure/pgo.py) on test_pgo.py's
  drifted 24-pose loop, both packages in f32 held against the port's solve
  in f64: the Sim3 steps between consecutive poses (free of the gauge)
  within 1e-4 per component, the poses themselves within PGO_TOL; the
  loop's endpoints brought together and the final cost dpvo_tpu's. A loop
  constraint 1% off fails the step bound. PGO_TOL is set from a reading
  of dpvo_tpu's own spread, which a test asserts: its f32 solve moves
  each pose by more than 1e-4 when the input poses move by 1e-7, while
  the steps move by less;
* the structure-only BA (ba.py, structure_only=True, PC = the keypoint
  count) against dpvo_tpu's (PC padded to 128) on a triplet of the classic
  scene, within 1e-5 relative, the poses untouched;
* ransac_umeyama (loop_closure/optim.py) bit-equal at a fixed seed, and
  make_sim3 equal.
"""
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_tpu import ba as jba
from dpvo_tpu import lie as jlie
from dpvo_tpu.loop_closure import optim as joptim
from dpvo_tpu.loop_closure import pgo as jpgo
from dpvo_torch import accuracy as acc
from dpvo_torch import ba as tba
from dpvo_torch import lie as tlie
from dpvo_torch.loop_closure import optim as toptim
from dpvo_torch.loop_closure import pgo as tpgo
from dpvo_torch.loop_closure.long_term import triangulate
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def _tangents(n=64, seed=0):
    """(n, 7) Sim3 tangents: random, then rows at theta < 1e-4, at unit
    scale (sigma = 0), both, and the identity."""
    xi = np.random.RandomState(seed).randn(n, 7).astype(np.float32) * 0.5
    xi[8:16, 3:6] *= 1e-5            # theta < 1e-4
    xi[16:24, 6] = 0.0               # unit scale
    xi[24:32, 3:6] *= 1e-5
    xi[24:32, 6] = 0.0
    xi[32:36] = 0.0                  # identity
    return xi


def _sim3(xi):
    return np.array(jlie.sim3_exp(jnp.asarray(xi)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize('op', ['exp', 'log', 'inv', 'mul', 'act'])
def test_sim3_matches_jax(op):
    xi = _tangents()
    S = _sim3(xi)
    S2 = _sim3(_tangents(seed=1)[::-1].copy())
    p = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    args = dict(exp=(xi,), log=(S,), inv=(S,), mul=(S, S2), act=(S, p))[op]
    want = np.asarray(getattr(jlie, f'sim3_{op}')(
        *[jnp.asarray(a) for a in args]))
    got = getattr(tlie, f'sim3_{op}')(*[_t(a) for a in args]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('op', ['exp', 'log', 'inv', 'mul', 'act'])
def test_rxso3_matches_jax(op):
    xi = _tangents()[:, 3:]                 # [phi, sigma]
    R = np.asarray(jlie.rxso3_exp(jnp.asarray(xi)))
    R2 = R[::-1].copy()
    p = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    args = dict(exp=(xi,), log=(R,), inv=(R,), mul=(R, R2), act=(R, p))[op]
    want = np.asarray(getattr(jlie, f'rxso3_{op}')(
        *[jnp.asarray(a) for a in args]))
    got = getattr(tlie, f'rxso3_{op}')(*[_t(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# The f32 LM stops on a flat valley at its rounding floor: dpvo_tpu's own
# the Sim3 PGO in f32 (either package) leaves each pose some 1e-4 - 1e-3
# from the f64 optimum (the residuals' f32 rounding), and dpvo_tpu moves
# its poses by up to 7.1e-4 per component when the input poses move by
# 1e-7 (test_pgo_f32_spread reads it); the poses are held at a few times
# that spread, and the steps between consecutive poses at STEP_TOL
PGO_TOL = 2e-3
STEP_TOL = 1e-4


def _drifted_loop(last=23):
    """test_pgo.py's scene: a 24-pose circle (world-to-camera) with seeded
    odometry drift, and the ground-truth Sim3 constraint from pose `last`
    to the first."""
    rng = np.random.RandomState(0)
    n = 24
    xi = np.zeros((n, 6), np.float32)
    xi[:, 0] = 0.3
    xi[:, 4] = 2 * np.pi / n
    gt, est = [np.asarray(jlie.se3_identity())], []
    for i in range(1, n):
        gt.append(np.asarray(jlie.se3_mul(jlie.se3_exp(jnp.asarray(xi[i])),
                                          jnp.asarray(gt[-1]))))
    est = [gt[0]]
    for i in range(1, n):
        noise = rng.randn(6).astype(np.float32) * 0.01
        est.append(np.asarray(jlie.se3_mul(
            jlie.se3_exp(jnp.asarray(xi[i] + noise)), jnp.asarray(est[-1]))))
    gt, est = np.stack(gt), np.stack(est)
    Ti = jlie.sim3_inv(jnp.asarray(jpgo.se3_to_sim3(gt[last])))
    Tj = jlie.sim3_inv(jnp.asarray(jpgo.se3_to_sim3(gt[0])))
    dS = np.asarray(jlie.sim3_mul(Tj, jlie.sim3_inv(Ti)))[None]
    return gt, est, dS, np.array([last]), np.array([0])


def _jacobian_cases():
    """(X, constants, iii, jjj) per case: random states and constants with
    the special rows of _tangents (Jacobians taken at them), and the
    drifted loop's first LM linearization point (unit scales, odometry
    constants near the identity)."""
    xi = _tangents()
    # the derivative of e^s - 1 over s loses f32 precision for 1e-8 <
    # |sigma| < 1e-2 in both packages: keep the random sigmas outside
    xi[:, 6] = np.where(xi[:, 6] == 0, 0.0,
                        np.sign(xi[:, 6]) * np.maximum(np.abs(xi[:, 6]),
                                                       2e-2))
    other = np.random.RandomState(3).randn(64, 7).astype(np.float32) * 0.3
    other[:, 6] = 0.0
    C = _sim3(np.random.RandomState(4).randn(64, 7).astype(np.float32) * 0.3)
    C[32:36] = _sim3(np.zeros((4, 7), np.float32))
    C = np.concatenate([C, C])
    X = np.concatenate([xi, other])
    ii, jj = np.arange(64), np.arange(64, 128)
    rand = (X, C, np.concatenate([ii, jj]), np.concatenate([jj, ii]))

    _, est, dS, li, lj = _drifted_loop()
    G = np.asarray(jlie.sim3_inv(jnp.asarray(jpgo.se3_to_sim3(est))))
    X = np.asarray(jlie.sim3_log(jnp.asarray(G)))
    kk = np.arange(1, len(est))
    dSij = np.asarray(jlie.sim3_mul(jnp.asarray(G[kk - 1]),
                                    jlie.sim3_inv(jnp.asarray(G[kk]))))
    loop = (X, np.concatenate([dSij, dS]), np.concatenate([kk, li]),
            np.concatenate([kk - 1, lj]))
    return dict(random=rand, loop=loop)


@pytest.mark.parametrize('case', ['random', 'loop'])
def test_residual_jacobians_match_jax(case):
    X, C, iii, jjj = _jacobian_cases()[case]
    r0, Ji0, Jj0 = jpgo.residual_and_jacobian(
        jnp.asarray(X), jnp.asarray(C), jnp.asarray(iii), jnp.asarray(jjj))
    r, Ji, Jj = tpgo.residual_and_jacobian(
        _t(X), _t(C), torch.from_numpy(iii), torch.from_numpy(jjj))
    for got, want in ((r, r0), (Ji, Ji0), (Jj, Jj0)):
        got, want = got.numpy(), np.asarray(want)
        assert np.isfinite(got).all()
        scale = np.abs(want).max(axis=(-2, -1) if want.ndim == 3 else -1)
        err = np.abs(got - want).max(axis=(-2, -1) if want.ndim == 3 else -1)
        assert (err <= 1e-4 * np.maximum(scale, 1.0)).all(), err.max()
    np.testing.assert_allclose(
        tpgo.residual_only(_t(X), _t(C), torch.from_numpy(iii),
                           torch.from_numpy(jjj)).numpy(),
        r.numpy(), rtol=0, atol=0)


def _f64(fn, *args, **kw):
    """The port's PGO entry `fn` with its tensors in f64 (the scipy solve
    is f64 in any case)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpgo, '_t', lambda a: torch.from_numpy(
            np.array(a, np.float64)))
        return fn(*(np.asarray(a, np.float64) if isinstance(a, np.ndarray)
                    and a.dtype.kind == 'f' else a for a in args), **kw)


def _steps(poses8, c2w=False):
    """The Sim3 steps between consecutive poses, in f64: T_k T_{k-1}^-1 of
    world-to-camera poses, T_{k-1}^-1 T_k of camera-to-world ones. A
    change of the world frame (the PGO's free gauge) leaves them as they
    are; a quaternion's sign is made that of w."""
    P = torch.from_numpy(np.asarray(poses8, np.float64))
    a, b = (tlie.sim3_inv(P[:-1]), P[1:]) if c2w else \
        (P[1:], tlie.sim3_inv(P[:-1]))
    S = tlie.sim3_mul(a, b).numpy()
    S[:, 3:7] *= np.sign(S[:, 6:7])
    return S


@pytest.fixture(scope='module')
def loop_updates():
    gt, est, dS, li, lj = _drifted_loop()
    return (gt, est, dS, li, lj,
            np.asarray(jpgo.perform_updates(est, dS, li, lj, iters=30)),
            tpgo.perform_updates(est, dS, li, lj, iters=30),
            _f64(tpgo.perform_updates, est, dS, li, lj, iters=30))


def _endpoint_err(poses8, gt):
    c0 = np.asarray(jlie.sim3_inv(jnp.asarray(poses8[0])))[:3]
    cN = np.asarray(jlie.sim3_inv(jnp.asarray(poses8[-1])))[:3]
    g0 = np.asarray(jlie.se3_inv(jnp.asarray(gt[0])))[:3]
    gN = np.asarray(jlie.se3_inv(jnp.asarray(gt[-1])))[:3]
    return np.linalg.norm((cN - c0) - (gN - g0))


def test_pgo_f32_spread(loop_updates):
    """The reading PGO_TOL is set from: dpvo_tpu's perform_updates on the
    drifted loop and on it with 1e-7 of seeded noise on every input
    component. Its poses move by more than 1e-4 (so the poses cannot be
    held to 1e-4) and less than PGO_TOL, by at least a third of it; the
    steps between them move by less than STEP_TOL."""
    _, est, dS, li, lj, want, _, _ = loop_updates
    noise = np.random.RandomState(1).randn(*est.shape) * 1e-7
    moved = np.asarray(jpgo.perform_updates(
        (est + noise).astype(np.float32), dS, li, lj, iters=30))
    spread = np.abs(moved - want).max()
    assert 1e-4 < spread < PGO_TOL < 4 * spread, spread
    assert np.abs(_steps(moved) - _steps(want)).max() < STEP_TOL


def test_perform_updates_matches_jax(loop_updates):
    gt, est, dS, li, lj, want, got, exact = loop_updates
    assert got.shape == want.shape == exact.shape == (len(est), 8)
    for f32 in (want, got):
        np.testing.assert_allclose(_steps(f32), _steps(exact), rtol=0,
                                   atol=STEP_TOL)
        np.testing.assert_allclose(f32, exact, rtol=0, atol=PGO_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=PGO_TOL)
    before = _endpoint_err(jpgo.se3_to_sim3(est), gt)
    assert _endpoint_err(got, gt) < 0.2 * before
    # the same objective value at both optima
    G = tlie.sim3_inv(_t(jpgo.se3_to_sim3(est)))
    kk = torch.arange(1, len(est))
    C = torch.cat([tlie.sim3_mul(G[kk - 1], tlie.sim3_inv(G[kk])), _t(dS)])
    iii = torch.cat([kk, torch.from_numpy(li)])
    jjj = torch.cat([kk - 1, torch.from_numpy(lj)])
    cost = [float((tpgo.residual_only(tlie.sim3_log(tlie.sim3_inv(_t(p))),
                                      C, iii, jjj) ** 2).mean())
            for p in (want, got)]
    assert cost[1] == pytest.approx(cost[0], rel=1e-2)
    # a wrong update fails the step bound: the loop constraint's
    # translation 1% off
    off = dS.copy()
    off[:, :3] *= 1.01
    wrong = tpgo.perform_updates(est, off, li, lj, iters=30)
    assert np.abs(_steps(wrong) - _steps(exact)).max() > 2 * STEP_TOL


def test_run_pgo_matches_jax():
    """The worker's entry point, called in process, on the loop closed at
    pose 19 (it re-anchors at pose safe_i = 20): the camera-to-world
    result of the first 20 poses, each package's f32 run against the
    port's f64 run as in test_perform_updates_matches_jax."""
    _, est, dS, li, lj = _drifted_loop(last=19)
    # the worker takes camera-to-world poses (long_term.close_loop)
    pred = np.asarray(jlie.se3_inv(jnp.asarray(est)))
    outs = []
    for run in (jpgo.run_DPVO_PGO, tpgo.run_DPVO_PGO,
                lambda *a: _f64(tpgo.run_DPVO_PGO, *a)):
        q = queue.Queue()
        run(pred, dS, li, lj, q)
        outs.append(q.get_nowait())
    want, got, exact = outs
    assert got.shape == want.shape == exact.shape == (li.max() + 1, 8)
    for f32 in (want, got):
        np.testing.assert_allclose(_steps(f32, c2w=True),
                                   _steps(exact, c2w=True), rtol=0,
                                   atol=STEP_TOL)
        np.testing.assert_allclose(f32, exact, rtol=0, atol=PGO_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=PGO_TOL)


def test_structure_only_ba_matches_jax():
    (poses3, xy, depth, intr, target), true = acc.plane_triplet(n=200)
    n = len(xy)
    got = triangulate(poses3, xy, depth, intr, target, device='cpu')

    kk = np.tile(np.arange(n), 2)
    ii = np.ones(2 * n, np.int32)
    jj = np.zeros(2 * n, np.int32)
    jj[n:] = 2
    PC = ((n + 127) // 128) * 128          # dpvo_tpu's TPU padding
    xy_p = jnp.zeros((PC, 2)).at[:n].set(xy)
    depth_p = jnp.zeros((PC,)).at[:n].set(depth)
    poses_out, want = jba.bundle_adjust(
        jnp.asarray(poses3), xy_p, depth_p, jnp.asarray(intr),
        jnp.asarray(target), jnp.ones((2 * n, 2), jnp.float32), 1e-3,
        jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk),
        jnp.ones(2 * n, bool), jnp.int32(3), jnp.int32(3), jnp.int32(0),
        W=4, PC=PC, iterations=6, structure_only=True)
    want = np.asarray(want)[:n]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert np.abs(got - true).max() < 0.1          # it triangulates

    # the port's poses come back untouched
    t = torch.from_numpy
    poses_t, _ = tba.bundle_adjust(
        t(poses3), t(xy), t(depth), t(intr), t(target),
        torch.ones(2 * n, 2), 1e-3, t(ii), t(jj), t(kk),
        torch.ones(2 * n, dtype=torch.bool), 3, 3, 0, W=4, PC=n,
        iterations=6, structure_only=True)
    np.testing.assert_array_equal(poses_t.numpy(), poses3)
    np.testing.assert_array_equal(np.asarray(poses_out), poses3)


def test_ransac_umeyama_bit_equal():
    """Seed 5 in both: dpvo_tpu makes RandomState(5) inside, the port
    draws from the RandomState(5) it is given."""
    rng = np.random.RandomState(0)
    src = rng.randn(120, 3) * 2
    R = np.asarray(jlie.quat_to_matrix(jnp.asarray(
        np.array([0.1, -0.2, 0.05, 0.97], np.float32) /
        np.linalg.norm([0.1, -0.2, 0.05, 0.97]))), np.float64)
    dst = 1.3 * src @ R.T + np.array([0.5, -0.1, 0.2])
    dst[::4] += rng.randn(30, 3)          # a quarter outliers
    want = joptim.ransac_umeyama(src, dst, iterations=400, threshold=0.1,
                                 seed=5)
    got = toptim.ransac_umeyama(src, dst, np.random.RandomState(5),
                                iterations=400, threshold=0.1)
    assert got[3] == want[3] >= 90
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(toptim.make_sim3(*got[:3]),
                                  joptim.make_sim3(*want[:3]))
