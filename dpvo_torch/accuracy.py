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
* the loop-closure gates (dpvo_tpu's tests/test_oracle_lc.py and
  test_dpv_slam_learned.py) on an out-and-back sequence
  (make_sequence(loop=True)): lc_run runs the runtime with or without
  LOOP_CLOSURE, with a network or with gt_oracle, the ground-truth
  reprojection targets from the sequence's poses and inverse depths.
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


# ---------------------------------------------------------------------------
# the loop-closure gates
# ---------------------------------------------------------------------------

def lc_cfg(loop_closure):
    """test_oracle_lc.py's and test_dpv_slam_learned.py's config: learned_cfg
    with proximity every 8 frames and BACKEND_THRESH 64."""
    cfg = learned_cfg()
    cfg.LOOP_CLOSURE = bool(loop_closure)
    cfg.GLOBAL_OPT_FREQ = 8           # the loop arc is ~T/2 frames
    cfg.BACKEND_THRESH = 64.0
    return cfg


def gt_oracle(seq):
    """Target oracle from make_sequence's ground truth (test_oracle_lc.py's
    make_gt_oracle): the inverse depth at each edge's patch center in frame
    ii (bilinear in disps4, at feature resolution), back-projected with the
    pose of ii and projected into jj; unit weights. Ground-truth depth keeps
    the targets consistent with the scene up to gauge, so normalize()'s
    rescale does not invalidate them."""
    gt_np = np.asarray(seq['poses_w2c'], np.float32)
    disps_np = np.asarray(seq['disps4'], np.float32)

    def oracle(poses, patch_xy, depth, intr, ii, jj, kk):
        gt = torch.as_tensor(gt_np, device=poses.device)
        disps = torch.as_tensor(disps_np, device=poses.device)
        c = patch_xy[kk][:, :, P // 2, P // 2]          # (E, 2) 1/RES px
        H4, W4 = disps.shape[1], disps.shape[2]
        x = c[:, 0].clamp(0.0, W4 - 1.001)
        y = c[:, 1].clamp(0.0, H4 - 1.001)
        x0 = x.floor().long()
        y0 = y.floor().long()
        fx_ = x - x0
        fy_ = y - y0
        d = ((1 - fy_) * ((1 - fx_) * disps[ii, y0, x0]
                          + fx_ * disps[ii, y0, x0 + 1])
             + fy_ * ((1 - fx_) * disps[ii, y0 + 1, x0]
                      + fx_ * disps[ii, y0 + 1, x0 + 1]))
        d = d.clamp(min=1e-4)
        fi, fj = intr[ii], intr[jj]
        d_c = torch.stack([(c[:, 0] - fi[:, 2]) / fi[:, 0],
                           (c[:, 1] - fi[:, 3]) / fi[:, 1],
                           torch.ones_like(c[:, 0])], dim=-1)
        wfc = lie.se3_inv(gt[ii])
        X_w = lie.quat_rotate(wfc[:, 3:7], d_c / d[:, None]) + wfc[:, :3]
        g = gt[jj]
        X_j = lie.quat_rotate(g[:, 3:7], X_w) + g[:, :3]
        z = X_j[:, 2].clamp(min=1e-3)
        target = torch.stack([fj[:, 0] * X_j[:, 0] / z + fj[:, 2],
                              fj[:, 1] * X_j[:, 1] / z + fj[:, 3]], dim=-1)
        return target, torch.ones_like(target)

    return oracle


def lc_run(seq, loop_closure, *, device, network=None, oracle=False,
           seed=7):
    """One run of lc_cfg on `seq` (make_sequence's dict), the motion probe
    forced: with oracle, HybridVO with gt_oracle's targets
    (test_oracle_lc.py's _run); else DPVO with `network` (a weights path,
    test_dpv_slam_learned.py's _run), which is DeviceVO without loop
    closure. Returns dict(ate, path, n_loop (proximity edges proposed),
    poses (T, 7) world-from-camera, slam)."""
    images = seq['images']
    T, H, W, _ = images.shape
    cfg = lc_cfg(loop_closure)
    if oracle:
        slam = HybridVO(cfg, None, ht=H, wd=W, seed=seed, device=device)
        slam._oracle = gt_oracle(seq)
    else:
        slam = DPVO(cfg, network, ht=H, wd=W, seed=seed, device=device)
    if isinstance(slam, HybridVO):
        slam.motion_probe = lambda: 100.0
    else:
        slam.force_accept = True
    for t in range(T):
        slam(t, images[t], seq['intrinsics'])
    poses, tstamps = slam.terminate()
    return dict(ate=trajectory_ate(poses, tstamps, seq['wfc']),
                path=path_length(seq['wfc']),
                n_loop=int(getattr(slam, '_n_loop_edges', 0)), poses=poses,
                slam=slam)
