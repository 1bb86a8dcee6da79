"""The accuracy gates' runs on the port, on any device.

* learned_ate: the runtime with a network on a synthetic sequence
  (data_readers/synthetic.py), the settings of dpvo_tpu's
  scripts/train_synthetic.py:run_vo_ate; Sim3-aligned ATE and path length.
* the oracle plane scene of dpvo_tpu's tests/test_oracle_ate.py: a
  fronto-parallel world plane, a known camera trajectory (plane_gt_poses)
  and ground-truth reprojection targets (plane_oracle) in place of the
  learned update, so the runtime's geometry, edge schedule, BA, keyframing
  and terminate() are held to ground truth without a trained network.
  oracle_hybrid runs HybridVO with no keyframe removal; oracle_removal runs
  DeviceVO through a dwell that makes keyframe removal fire.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lie
from .config import cfg as base_cfg
from .evaluation import ate_rmse, poses_to_trajectory
from .models.vonet import P
from .runtime import DPVO, DeviceVO, HybridVO
from .runtime import numpy_se3 as nse3

PLANE_Z = 3.0          # world plane z = const, cameras look down +z
ORACLE_HW = (64, 96)
ORACLE_FRAMES = 30
ORACLE_INTR = np.array([80.0, 80.0, 48.0, 32.0], np.float32)


def path_length(wfc):
    """Summed distance between consecutive positions of (T, 7) poses."""
    return float(np.linalg.norm(np.diff(wfc[:, :3], axis=0), axis=1).sum())


def trajectory_ate(poses, tstamps, gt_wfc):
    """Sim3-aligned ATE of (T, 7) world-from-camera poses against the
    ground truth of input frames 0 .. len(gt_wfc) - 1."""
    return float(ate_rmse(poses_to_trajectory(poses, tstamps),
                          poses_to_trajectory(gt_wfc,
                                              np.arange(len(gt_wfc))),
                          correct_scale=True))


def learned_cfg(upload='rgb'):
    """run_vo_ate's config: short windows, no keyframe removal, f32."""
    cfg = base_cfg.clone()
    cfg.BUFFER_SIZE = 128
    cfg.PATCHES_PER_FRAME = 8
    cfg.PATCH_LIFETIME = 6
    cfg.REMOVAL_WINDOW = 12
    cfg.OPTIMIZATION_WINDOW = 10
    cfg.KEYFRAME_THRESH = -1.0        # keep every frame: pure-VO accuracy
    cfg.MIXED_PRECISION = False
    cfg.UPLOAD_FORMAT = upload
    return cfg


def learned_ate(network, seq, *, device, upload='rgb', seed=7):
    """(ATE, path length) of DPVO with `network` (a weights path or None
    for seeded random weights) on `seq` (make_sequence's dict), the motion
    probe forced."""
    images = seq['images']
    T, H, W, _ = images.shape
    slam = DPVO(learned_cfg(upload), network, ht=H, wd=W, seed=seed,
                device=device)
    slam.force_accept = True
    for t in range(T):
        slam(t, images[t], seq['intrinsics'])
    poses, tstamps = slam.terminate()
    return trajectory_ate(poses, tstamps, seq['wfc']), path_length(seq['wfc'])


# ---------------------------------------------------------------------------
# the oracle plane scene
# ---------------------------------------------------------------------------

def plane_gt_poses(n, dwell=None, step=0.25, dwell_step=0.05):
    """(n, 7) cam-from-world: x advances `step` per frame (`dwell_step` for
    frames in [dwell[0], dwell[1])), with a wobble in y, z and yaw; ~2 px
    of flow per frame at the feature scale."""
    poses = np.zeros((n, 7), np.float32)
    x = 0.0
    for i in range(n):
        yaw = 0.03 * np.sin(0.2 * i)
        pos = np.array([x, 0.05 * np.sin(0.3 * i), 0.1 * np.sin(0.17 * i)])
        q = np.array([0.0, np.sin(yaw / 2), 0.0, np.cos(yaw / 2)])
        poses[i] = nse3.inv(np.concatenate([pos, q]).astype(np.float32))
        x += dwell_step if dwell and dwell[0] <= i < dwell[1] else step
    return poses


def plane_oracle(gt_poses):
    """Target oracle (poses, patch_xy, depth, intr, ii, jj, kk) -> (target,
    weight): each edge's patch center at frame ii, cast onto the plane
    z = PLANE_Z with the ground-truth pose of ii and projected into frame
    jj with that of jj; unit weights."""
    gt_np = np.asarray(gt_poses, np.float32)

    def oracle(poses, patch_xy, depth, intr, ii, jj, kk):
        gt = torch.as_tensor(gt_np, device=poses.device)
        c = patch_xy[kk][:, :, P // 2, P // 2]        # (E, 2) 1/RES pixels
        fi, fj = intr[ii], intr[jj]
        d_c = torch.stack([(c[:, 0] - fi[:, 2]) / fi[:, 0],
                           (c[:, 1] - fi[:, 3]) / fi[:, 1],
                           torch.ones_like(c[:, 0])], dim=-1)
        wfc = lie.se3_inv(gt[ii])                      # world-from-cam i
        d_w = lie.quat_rotate(wfc[:, 3:7], d_c)
        lam = (PLANE_Z - wfc[:, 2]) / d_w[:, 2]
        X_w = wfc[:, :3] + lam[:, None] * d_w
        g = gt[jj]
        X_j = lie.quat_rotate(g[:, 3:7], X_w) + g[:, :3]
        Z = X_j[:, 2].clamp(min=0.1)
        target = torch.stack([fj[:, 0] * X_j[:, 0] / Z + fj[:, 2],
                              fj[:, 1] * X_j[:, 1] / Z + fj[:, 3]], dim=-1)
        return target, torch.ones_like(target)

    return oracle


class ConstDepthRng:
    """rng wrapper: constant inverse-depth seeds (rand), every other draw
    passed through. With fixed oracle targets a uniform-random depth seed
    can trap Gauss-Newton in a local minimum; a constant one keeps the
    gate about geometry, BA and scheduling."""

    def __init__(self, rng):
        self._rng = rng

    def rand(self, *shape):
        return np.full(shape, 0.5)

    def __getattr__(self, name):
        return getattr(self._rng, name)


def oracle_cfg(kf_thresh):
    """test_oracle_ate.py's config: M = 4, windows of 10, f32."""
    cfg = base_cfg.clone()
    cfg.BUFFER_SIZE = 64
    cfg.PATCHES_PER_FRAME = 4
    cfg.PATCH_LIFETIME = 5
    # above the 8-frame bootstrap, so that no edge counts as long-range
    cfg.REMOVAL_WINDOW = 10
    cfg.OPTIMIZATION_WINDOW = 10
    cfg.KEYFRAME_THRESH = kf_thresh
    cfg.MIXED_PRECISION = False
    return cfg


def _oracle_run(slam, gt_poses, reseed):
    """Feed the scene's seeded random frames; returns the result dict."""
    H, W = ORACLE_HW
    rng = np.random.RandomState(1)
    for t in range(ORACLE_FRAMES):
        img = rng.randint(0, 255, (H, W, 3), np.uint8)
        if reseed:
            slam.rng = ConstDepthRng(np.random.RandomState(1000 + t))
        slam(t, img, ORACLE_INTR)
    if isinstance(slam, HybridVO):
        slam._drain()
    keyframes = slam.n
    poses, tstamps = slam.terminate()
    gt_wfc = nse3.inv(gt_poses)
    return dict(poses=poses, keyframes=keyframes, path=path_length(gt_wfc),
                ate=trajectory_ate(poses, tstamps, gt_wfc))


def oracle_hybrid(device):
    """test_oracle_ate.py's first case: HybridVO, no keyframe removal."""
    gt = plane_gt_poses(ORACLE_FRAMES)
    slam = HybridVO(oracle_cfg(-1.0), None, *ORACLE_HW, seed=3,
                    device=device)
    slam._oracle = plane_oracle(gt)
    slam.motion_probe = lambda: 100.0
    slam.rng = ConstDepthRng(slam.rng)
    return _oracle_run(slam, gt, reseed=False)


def oracle_removal(device):
    """test_oracle_ate.py's second case: DeviceVO through a dwell (frames
    12-18 move a fifth as far), KEYFRAME_THRESH 0.8, so that keyframe
    removal fires."""
    gt = plane_gt_poses(ORACLE_FRAMES, dwell=(12, 19))
    slam = DeviceVO(oracle_cfg(0.8), None, *ORACLE_HW, seed=3, device=device)
    slam._oracle = plane_oracle(gt)
    slam.force_accept = True
    return _oracle_run(slam, gt, reseed=True)
