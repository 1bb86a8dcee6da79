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
* the classic loop closure's scene (dpvo_tpu's tests/test_classic_lc.py):
  an out-and-back pan over a textured world plane (classic_scene), so that
  revisits render near-identical frames and retrieval, ORB matching and
  triangulation run on real signal; classic_run runs HybridVO with
  CLASSIC_LOOP_CLOSURE on it, with plane_oracle or a network. sync_pgo is
  the seam that makes such runs deterministic.
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
    on_device = {}             # the poses uploaded once per device

    def oracle(poses, patch_xy, depth, intr, ii, jj, kk):
        gt = on_device.get(poses.device)
        if gt is None:
            gt = on_device[poses.device] = torch.as_tensor(
                gt_np, device=poses.device)
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


# ---------------------------------------------------------------------------
# the classic loop closure's scene
# ---------------------------------------------------------------------------

# test_classic_lc.py's retrieval settings: default.yaml's 50-frame radius
# is longer than its 36-frame sequence
CLASSIC_RETRIEVAL = dict(LOOP_RETR_RAD=8, LOOP_CLOSE_WINDOW_SIZE=2,
                         LOOP_RETR_THRESH=0.005)
CLASSIC_HW = (128, 192)
CLASSIC_FRAMES = 36


def textured_frames(n, H=96, W=128, seed=0):
    """test_classic_lc.py's pan over seeded blobs and edges (ORB finds
    corners on them), out and back: frames t and n - 1 - t are equal."""
    rng = np.random.RandomState(seed)
    base = np.zeros((H * 3, W * 3), np.uint8)
    for _ in range(300):
        y, x = rng.randint(0, H * 3 - 12), rng.randint(0, W * 3 - 12)
        base[y:y + rng.randint(3, 12), x:x + rng.randint(3, 12)] = \
            rng.randint(0, 255)
    base = np.stack([base] * 3, -1)
    out = []
    for t in range(n):
        s = t if t < n // 2 else (n - 1 - t)
        out.append(base[2 * s:2 * s + H, 3 * s:3 * s + W].copy())
    return out


def render_plane_sequence(gt_cfw, H, W, intr, plane_z=PLANE_Z, seed=7):
    """Views of a blocky textured world plane z = plane_z (inverse warp;
    test_classic_lc.py's _render_plane_sequence): (H, W, 3) uint8 frames
    for the (T, 7) cam-from-world poses."""
    rng = np.random.RandomState(seed)
    T = 1024
    tex = rng.randint(0, 255, (T // 8, T // 8)).astype(np.float32)
    tex = np.kron(tex, np.ones((8, 8), np.float32))
    fx, fy, cx, cy = intr

    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)

    frames = []
    for P_cfw in np.asarray(gt_cfw, np.float32):
        wfc = nse3.inv(P_cfw)
        o = wfc[:3]
        d = nse3.quat_rotate(np.broadcast_to(wfc[3:7], rays.shape[:2] + (4,)),
                             rays)
        lam = (plane_z - o[2]) / d[..., 2]
        Xw = o[None, None, :] + lam[..., None] * d
        tx = np.mod(Xw[..., 0] * 160.0, T).astype(np.int64)
        ty = np.mod(Xw[..., 1] * 160.0, T).astype(np.int64)
        img = tex[ty % tex.shape[0], tx % tex.shape[1]]
        frames.append(np.stack([img] * 3, -1).astype(np.uint8))
    return frames


def classic_gt(n=CLASSIC_FRAMES, amplitude=1.5):
    """(n, 7) cam-from-world: out and back along x, x = amplitude sin(pi t
    / (n - 1)), so frames k and n - 1 - k see the same view."""
    gt = np.zeros((n, 7), np.float32)
    for t in range(n):
        x = amplitude * np.sin(np.pi * t / (n - 1))
        gt[t] = nse3.inv(np.array([x, 0, 0, 0, 0, 0, 1], np.float32))
    return gt


def classic_scene(n=CLASSIC_FRAMES, H=CLASSIC_HW[0], W=CLASSIC_HW[1]):
    """(gt cam-from-world, frames, intrinsics) of test_classic_lc.py's
    closed-loop scene, the focal length 160 px at 128x192 scaled with W."""
    f = 160.0 * W / 192
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    gt = classic_gt(n)
    return gt, render_plane_sequence(gt, H, W, intr), intr


def classic_cfg(mixed=False):
    """test_classic_lc.py's config: oracle_cfg(-1) with the classic
    backend and its retrieval settings."""
    cfg = oracle_cfg(-1.0)
    cfg.MIXED_PRECISION = bool(mixed)
    cfg.CLASSIC_LOOP_CLOSURE = True
    for k, v in CLASSIC_RETRIEVAL.items():
        cfg[k] = v
    return cfg


def sync_pgo(lc):
    """Make a LongTermLoopClosure instance (the port's or dpvo_tpu's) apply
    each pose-graph result as soon as its close_loop succeeds, instead of
    whenever the worker happens to finish: the seam that makes CPU / CUDA
    and port / dpvo_tpu runs comparable. Nothing on the runtime path calls
    it. Returns lc."""
    close_loop = lc.close_loop

    def synced(i, j, n):
        closed = close_loop(i, j, n)
        if closed:
            lc.lc_callback(skip_if_empty=False)
        return closed

    lc.close_loop = synced
    return lc


def classic_run(device, *, network=None, oracle=True, mixed=False,
                scene=None, classic=True, stop=None):
    """HybridVO with classic_cfg on classic_scene (or `scene`, its triple),
    seed 3, with plane_oracle's targets or `network` (a weights path, None
    for seeded random weights), constant depth seeds, the motion probe
    forced and sync_pgo; classic=False runs the same without the classic
    backend. With `stop`, stop(slam) runs after the frames and before
    terminate(). Returns dict(poses (T, 7) world-from-camera, ate, path,
    lc_count, loops [(i, j)], slam)."""
    gt, frames, intr = scene or classic_scene()
    H, W, _ = frames[0].shape
    cfg = classic_cfg(mixed)
    cfg.CLASSIC_LOOP_CLOSURE = bool(classic)
    slam = HybridVO(cfg, network, ht=H, wd=W, seed=3, device=device)
    lc = slam.long_term_lc
    if lc is not None:
        sync_pgo(lc)
    if oracle:
        slam._oracle = plane_oracle(gt)
    slam.motion_probe = lambda: 100.0
    slam.rng = ConstDepthRng(slam.rng)
    for t, img in enumerate(frames):
        slam(t, img, intr)
    if stop is not None:
        stop(slam)
    poses, tstamps = slam.terminate()
    gt_wfc = nse3.inv(gt)
    loops = ([] if lc is None else
             list(zip(lc.loop_ii.tolist(), lc.loop_jj.tolist())))
    return dict(poses=poses, ate=trajectory_ate(poses, tstamps, gt_wfc),
                path=path_length(gt_wfc), lc_count=lc and lc.lc_count,
                loops=loops, slam=slam)


def plane_triplet(i=9, n=512):
    """A keypoint triplet of classic_scene for the structure-only BA, from
    the scene's geometry instead of ORB: n seeded pixels of frame i at full
    resolution, their targets in frames i - 1 and i + 1 (projected through
    the plane with the ground-truth poses, plus 0.3 px of seeded Gaussian
    noise), depth seeds 0.4. Returns (triangulate's arguments (poses3, xy,
    depth, intr, target), the true inverse depths (n,))."""
    gt = classic_gt()
    H, W = CLASSIC_HW
    intr = np.array([160.0, 160.0, W / 2, H / 2], np.float32)
    fx, fy, cx, cy = intr
    rng = np.random.RandomState(0)
    xy = (rng.rand(n, 2) * [W - 1, H - 1]).astype(np.float32)
    d_c = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy,
                    np.ones(n, np.float32)], -1)
    wfc = nse3.inv(gt[i])
    d_w = nse3.quat_rotate(np.broadcast_to(wfc[3:7], (n, 4)), d_c)
    X_w = wfc[:3] + ((PLANE_Z - wfc[2]) / d_w[:, 2])[:, None] * d_w
    inv_depth = 1.0 / nse3.act(np.broadcast_to(gt[i], (n, 7)), X_w)[:, 2]
    target = []
    for f in (i - 1, i + 1):
        X = nse3.act(np.broadcast_to(gt[f], (n, 7)), X_w)
        target.append(np.stack([fx * X[:, 0] / X[:, 2] + cx,
                                fy * X[:, 1] / X[:, 2] + cy], -1))
    target = (np.concatenate(target) +
              0.3 * rng.randn(2 * n, 2)).astype(np.float32)
    return ((gt[i - 1:i + 2].copy(), xy, np.full(n, 0.4, np.float32),
             intr, target), inv_depth.astype(np.float32))
