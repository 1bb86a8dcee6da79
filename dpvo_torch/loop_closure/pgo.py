"""Sim3 pose-graph optimization (the classic loop-closure backend).

Port of dpvo_tpu/loop_closure/pgo.py, which mirrors the reference PGO
(dpvo/loop_closure/optim_utils.py:152-243 + the Eigen sparse solver in
dpvo/fastba/ba.cpp:99-180):

  * states: global-tangent coordinates X of the INVERSE Sim3 poses,
    updated ADDITIVELY (X += dx), like the reference's
    `Ginv = Log(Sim3(poses).Inv())` parametrization;
  * residuals: r_e = Log(C_e * Exp(X_i) * Exp(X_j)^-1) with constants C_e =
    odometry chain factors + measured loop Sim3s;
  * Jacobians: torch.func.vmap(torch.func.jacfwd(...)) through dpvo_torch.lie
    (the reference takes them with pypose's torch.autograd.functional);
  * LM loop with accept/reject and lambda doubling/halving, normal
    equations solved with scipy.sparse (the reference: Eigen
    SimplicialCholesky).

This module runs on the CPU by design, not as a fallback: the reference
runs its PGO in a pool process on the CPU (pypose + Eigen), and so do
dpvo_tpu and this port. The residuals and Jacobians are f32 tensors on the
CPU and the sparse solve is f64 in scipy. run_DPVO_PGO is the worker's
entry point: it never initializes CUDA, and its inputs and result are
numpy arrays. apply_pgo_result writes the result into the live HybridVO
(on its device); like the solve, it needs no OpenCV.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from .. import lie


def se3_to_sim3(poses):
    """(.., 7) SE3 -> (.., 8) Sim3 with unit scale."""
    s = np.ones(poses.shape[:-1] + (1,), poses.dtype)
    return np.concatenate([poses, s], axis=-1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _residual_one(C, Gi, Gj):
    """Log(C * Exp(Gi) * Exp(Gj)^-1) for one edge (optim_utils.py:158-161)."""
    T = lie.sim3_mul(C, lie.sim3_mul(lie.sim3_exp(Gi),
                                     lie.sim3_inv(lie.sim3_exp(Gj))))
    return lie.sim3_log(T)


_jacobians = torch.func.vmap(torch.func.jacfwd(_residual_one,
                                               argnums=(1, 2)))


def residual_and_jacobian(X, constants, iii, jjj):
    """r (E, 7), J_i (E, 7, 7), J_j (E, 7, 7); X (n, 7), constants (E, 8),
    iii / jjj (E,) long, all CPU tensors."""
    Gi, Gj = X[iii], X[jjj]
    r = _residual_one(constants, Gi, Gj)
    Ji, Jj = _jacobians(constants, Gi, Gj)
    return r, Ji, Jj


def residual_only(X, constants, iii, jjj):
    return _residual_one(constants, X[iii], X[jjj])


def solve_system(J_i, J_j, ii, jj, res, ep, lm, freen):
    """Sparse normal-equations solve (mirrors ba.cpp:120-172).

    Returns delta (n, 7). If freen >= 0, only the first freen poses move.
    """
    J_i = np.asarray(J_i, np.float64)
    J_j = np.asarray(J_j, np.float64)
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    res = np.asarray(res, np.float64).reshape(-1)

    r = J_i.shape[0]
    n = int(max(ii.max(), jj.max())) + 1

    rows = np.repeat(np.arange(r * 7).reshape(r, 7), 7, axis=-1).reshape(-1)
    cols_i = ((ii[:, None, None] * 7) +
              np.broadcast_to(np.arange(7)[None, None, :], (r, 7, 7))).reshape(-1)
    cols_j = ((jj[:, None, None] * 7) +
              np.broadcast_to(np.arange(7)[None, None, :], (r, 7, 7))).reshape(-1)

    J = scipy.sparse.csr_matrix(
        (np.concatenate([J_i.reshape(-1), J_j.reshape(-1)]),
         (np.concatenate([rows, rows]), np.concatenate([cols_i, cols_j]))),
        shape=(r * 7, n * 7))

    b = -(J.T @ res)
    A = (J.T @ J).tocsc()
    diag = A.diagonal()
    A = A + scipy.sparse.diags(diag * lm + ep)

    if freen >= 0:
        k = freen * 7
        A_sub = A[:k, :k]
        b_sub = b[:k]
        delta = np.zeros(n * 7)
        delta[:k] = scipy.sparse.linalg.spsolve(A_sub.tocsc(), b_sub)
    else:
        delta = scipy.sparse.linalg.spsolve(A, b)

    return delta.reshape(n, 7).astype(np.float32)


def perform_updates(input_poses, dSloop, ii_loop, jj_loop, iters=30, ep=0.0,
                    lmbda=1e-6, fix_opt_window=False):
    """LM loop (optim_utils.py:211-243).

    input_poses: (n, 7) SE3 world-to-camera (numpy)
    dSloop: (L, 8) measured Sim3 loop constraints
    Returns (n, 8) optimized Sim3 poses (world-to-camera, i.e. Exp(X).Inv()).
    """
    input_poses = np.asarray(input_poses, np.float32)
    n = input_poses.shape[0]

    freen = int(max(ii_loop.max(), jj_loop.max())) + 1 if fix_opt_window \
        else -1

    # X = Log(Sim3(poses).Inv())
    Ginv_group = lie.sim3_inv(_t(se3_to_sim3(input_poses)))
    X = lie.sim3_log(Ginv_group).numpy()

    # odometry chain constants from the current estimate
    kk = np.arange(1, n)
    ll = kk - 1
    dSij = lie.sim3_mul(Ginv_group[ll], lie.sim3_inv(Ginv_group[kk]))

    constants = torch.cat([dSij, _t(dSloop)])
    iii = np.concatenate([kk, np.asarray(ii_loop)])
    jjj = np.concatenate([ll, np.asarray(jj_loop)])
    iii_t = torch.from_numpy(iii).long()
    jjj_t = torch.from_numpy(jjj).long()

    history = []
    for itr in range(iters):
        r, Ji, Jj = residual_and_jacobian(_t(X), constants, iii_t, jjj_t)
        r = r.numpy()
        history.append(float((r ** 2).mean()))

        delta = solve_system(Ji.numpy(), Jj.numpy(), iii, jjj, r, ep, lmbda,
                             freen)
        X_new = X + delta
        r_new = residual_only(_t(X_new), constants, iii_t, jjj_t).numpy()
        if (r_new ** 2).mean() < history[-1]:
            X = X_new
            lmbda /= 2
        else:
            lmbda *= 2

        if history[-1] < 1e-5 and itr >= 4 and \
                history[-5] / max(history[-1], 1e-30) < 1.5:
            break

    # Exp(X).Inv(): optimized world-to-camera Sim3
    return lie.sim3_inv(lie.sim3_exp(_t(X))).numpy()


def run_DPVO_PGO(pred_poses, loop_poses, loop_ii, loop_jj, queue):
    """Async worker entry (optim_utils.py:202-209): re-anchor the result at
    the first pose after the last loop endpoint and put the (safe_i, 8)
    camera-to-world Sim3s on `queue`."""
    final_est = perform_updates(pred_poses, loop_poses, loop_ii, loop_jj,
                                iters=30)
    safe_i = int(np.asarray(loop_ii).max()) + 1
    aa = _t(se3_to_sim3(np.asarray(pred_poses, np.float32)))
    est = _t(final_est)
    anchor = lie.sim3_mul(aa[safe_i], lie.sim3_inv(est[safe_i]))
    out = lie.sim3_mul(anchor[None], est).numpy()
    queue.put(out[:safe_i])


def apply_pgo_result(slam, final_est):
    """Write a PGO result into the live HybridVO `slam` (reference
    long_term.py:189-203): final_est (safe_i, 8) are optimized Sim3s
    camera-to-world of the first safe_i keyframes. Their inverses become
    the poses, their depths are divided by each frame's scale, the removed
    frames' deltas are rescaled by their source keyframe's scale, and the
    device rows are written (after a keyframe removal the device still
    owed), then gauge-normalized, and the host mirrors read back. The
    mirrors in flight (MIRROR_PIPELINE > 1) are applied first, so that
    none computed before the result lands after it. It needs
    no OpenCV (the runtime package is imported here, not at module level,
    so that the PGO worker does not load it)."""
    from ..runtime import numpy_se3 as nse3
    slam._apply_in_flight()
    safe_i = final_est.shape[0]
    res = nse3.inv(final_est[:, :7])
    s = final_est[:, 7]

    s1 = np.ones(slam.n, np.float32)
    s1[:safe_i] = s

    slam.poses_np[:safe_i] = res
    M = slam.M
    slam.depth_np[:safe_i * M] /= np.repeat(s, M)
    _rescale_deltas(slam, s1)

    slam._flush_pending()
    st = slam.st
    st.poses[:safe_i] = torch.from_numpy(
        slam.poses_np[:safe_i].copy()).to(st.poses)
    st.depth[:safe_i * M] = torch.from_numpy(
        slam.depth_np[:safe_i * M].copy()).to(st.depth)
    slam.normalize()
    # dpvo_tpu leaves the mirrors in the gauge before normalize until the
    # window's next refresh
    slam._refresh_mirrors()


def _rescale_deltas(slam, s):
    """Rescale removed-frame deltas by their source-keyframe scale
    (reference long_term.py:175-187)."""
    tstamp_2_rescale = {}
    for i in range(slam.n):
        tstamp_2_rescale[slam.tstamps_[i]] = s[i]

    for t, (t0, dP) in slam.delta.items():
        t_src = t
        while t_src in slam.delta:
            t_src, _ = slam.delta[t_src]
        s1 = tstamp_2_rescale.get(t_src, 1.0)
        dPs = dP.copy()
        dPs[:3] *= s1
        slam.delta[t] = (t0, dPs)
