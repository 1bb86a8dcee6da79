"""Trajectory evaluation: Umeyama alignment + ATE RMSE, and trajectory
files.

Copy of dpvo_tpu/evaluation.py (numpy only; copied so this package never
imports the JAX package): the evo-equivalent metric of the reference's
evaluation scripts (evaluate_tartan.py:60-67): associate by timestamp,
align the estimate to ground truth with a (scaled) rigid transform, report
translation RMSE; the TUM writer and the TUM / EuRoC readers the demo and
the evaluation CLIs use.
"""
from __future__ import annotations

import numpy as np


class PoseTrajectory3D:
    """Minimal evo-compatible trajectory container."""

    def __init__(self, positions_xyz, orientations_quat_wxyz, timestamps):
        self.positions_xyz = np.asarray(positions_xyz, float)
        self.orientations_quat_wxyz = np.asarray(orientations_quat_wxyz, float)
        self.timestamps = np.asarray(timestamps, float)


def umeyama_alignment(x, y, with_scale=True):
    """Least-squares similarity transform y ~ c R x + t.

    x, y: (3, N). Returns (R, t, c). Standard Umeyama (1991) closed form —
    same algorithm evo and the reference's RANSAC loop use
    (dpvo/loop_closure/optim_utils.py:65-108).
    """
    mx = x.mean(axis=1, keepdims=True)
    my = y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    sx = (xc ** 2).sum() / n
    cov = yc @ xc.T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    # a degenerate (collapsed-to-a-point) estimate has sx == 0; keep the
    # alignment finite so a broken trajectory scores a LARGE error, not nan
    c = np.trace(np.diag(d) @ S) / max(sx, 1e-12) if with_scale else 1.0
    t = my - c * R @ mx
    return R, t, c


def associate(t_est, t_gt, max_diff=0.08):
    """Greedy nearest-timestamp association; returns index pairs."""
    ei, gi = [], []
    j = 0
    order = np.argsort(t_gt)
    t_gt_sorted = t_gt[order]
    for i, t in enumerate(t_est):
        j = np.searchsorted(t_gt_sorted, t)
        cand = [c for c in (j - 1, j) if 0 <= c < len(t_gt_sorted)]
        if not cand:
            continue
        best = min(cand, key=lambda c: abs(t_gt_sorted[c] - t))
        if abs(t_gt_sorted[best] - t) <= max_diff:
            ei.append(i)
            gi.append(order[best])
    return np.asarray(ei, int), np.asarray(gi, int)


def ate_rmse(traj_est, traj_gt, correct_scale=True, max_diff=0.08):
    """APE translation RMSE after (Sim3) alignment — evo-equivalent."""
    ei, gi = associate(traj_est.timestamps, traj_gt.timestamps, max_diff)
    if len(ei) < 3:
        return float('inf')
    x = traj_est.positions_xyz[ei].T
    y = traj_gt.positions_xyz[gi].T
    R, t, c = umeyama_alignment(x, y, with_scale=correct_scale)
    err = (c * R @ x + t) - y
    return float(np.sqrt((err ** 2).sum(axis=0).mean()))


def save_trajectory_tum_format(traj, path):
    """TUM format: t x y z qx qy qz qw (evo-compatible)."""
    with open(path, 'w') as f:
        for i in range(len(traj.timestamps)):
            p = traj.positions_xyz[i]
            qw, qx, qy, qz = traj.orientations_quat_wxyz[i]
            f.write(f'{traj.timestamps[i]} {p[0]} {p[1]} {p[2]} '
                    f'{qx} {qy} {qz} {qw}\n')


def read_tum_trajectory_file(path):
    data = np.loadtxt(path, comments='#')
    return PoseTrajectory3D(
        positions_xyz=data[:, 1:4],
        orientations_quat_wxyz=data[:, [7, 4, 5, 6]],
        timestamps=data[:, 0])


def read_euroc_csv_trajectory(path):
    """EuRoC groundtruth csv (state_groundtruth_estimate0/data.csv)."""
    data = np.loadtxt(path, delimiter=',', skiprows=1)
    return PoseTrajectory3D(
        positions_xyz=data[:, 1:4],
        orientations_quat_wxyz=data[:, 4:8],
        timestamps=data[:, 0] / 1e9)


def poses_to_trajectory(poses, tstamps):
    """(N, 7) [x y z qx qy qz qw] + timestamps -> PoseTrajectory3D."""
    poses = np.asarray(poses)
    return PoseTrajectory3D(
        positions_xyz=poses[:, :3],
        orientations_quat_wxyz=poses[:, [6, 3, 4, 5]],
        timestamps=np.asarray(tstamps, float))
