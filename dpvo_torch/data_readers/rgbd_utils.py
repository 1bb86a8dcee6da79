"""Dense-flow frame-graph utilities (NumPy).

Copy of dpvo_tpu/data_readers/rgbd_utils.py over this package's
runtime/numpy_se3 (dpvo_tpu's imports dpvo_tpu.runtime, and JAX with it).
Replaces the reference dpvo/data_readers/rgbd_utils.py:103-141: the mean
induced optical-flow magnitude between frame pairs from poses +
downsampled disparity maps, which builds the co-visibility graph that
training clips are sampled from. loadtum reads np.str_ where dpvo_tpu
reads np.unicode_, the same type under the name numpy 2 kept.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..runtime import numpy_se3 as nse3


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Flow magnitude of frame i's pixels reprojected into frame j.

    poses: (N, 7) world-to-camera; disps: (N, h, w) inverse depth at the
    downsampled resolution; intrinsics: (N, 4) already downscaled.
    Returns (flow (E, h, w), valid (E, h, w) f32).
    """
    N, h, w = disps.shape
    fx, fy, cx, cy = [intrinsics[0, k] for k in range(4)]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing='ij')
    xs = xs.astype(np.float32)
    ys = ys.astype(np.float32)

    Gij = nse3.mul(poses[jj], nse3.inv(poses[ii]))        # (E, 7)

    xn = (xs[None] - cx) / fx                              # (1, h, w)
    yn = (ys[None] - cy) / fy
    d = disps[ii]                                          # (E, h, w)
    X0 = np.stack([np.broadcast_to(xn, d.shape),
                   np.broadcast_to(yn, d.shape),
                   np.ones_like(d), d], axis=-1)
    R = Gij[:, None, None, 3:7]
    t = Gij[:, None, None, :3]
    X1 = np.concatenate([
        nse3.quat_rotate(R, X0[..., :3]) + X0[..., 3:4] * t,
        X0[..., 3:4]], axis=-1)
    Z = X1[..., 2]
    valid = Z > 0.2
    Zs = np.maximum(Z, 0.2)
    x1 = fx * X1[..., 0] / Zs + cx
    y1 = fy * X1[..., 1] / Zs + cy
    flow = np.sqrt((x1 - xs) ** 2 + (y1 - ys) ** 2)
    return flow, valid.astype(np.float32)


def compute_distance_matrix_flow(poses, disps, intrinsics, chunk=512):
    """All-pairs mean-flow distance matrix (reference rgbd_utils.py:103-141),
    `chunk` pairs at a time.

    World-to-camera poses are derived here (the reference inverts
    camera-to-world inputs, :107-108).
    """
    poses = nse3.inv(np.asarray(poses, np.float32))
    disps = np.asarray(disps, np.float32)
    intrinsics = np.asarray(intrinsics, np.float32)
    N = poses.shape[0]

    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing='ij')
    ii, jj = ii.ravel(), jj.ravel()

    MAX_FLOW = 100.0
    matrix = np.zeros((N, N), np.float32)
    for s in range(0, len(ii), chunk):
        i1, j1 = ii[s:s + chunk], jj[s:s + chunk]
        f1, v1 = induced_flow(poses, disps, intrinsics, i1, j1)
        f2, v2 = induced_flow(poses, disps, intrinsics, j1, i1)
        flow = np.stack([f1, f2], axis=1).reshape(len(i1), -1)
        val = np.stack([v1, v2], axis=1).reshape(len(i1), -1)
        flow = np.minimum(flow, MAX_FLOW)
        vm = val.mean(-1)
        mag = (flow * val).mean(-1) / np.maximum(vm, 1e-6)
        mag[vm < 0.7] = np.inf
        matrix[i1, j1] = mag
    return matrix


def loadtum(datapath, frame_rate=-1):
    """TUM-format RGB-D association (reference rgbd_utils.py:9-60):
    (image paths, depth paths, pose rows), or (None, None, None) without a
    groundtruth.txt / pose.txt."""
    if osp.isfile(osp.join(datapath, 'groundtruth.txt')):
        pose_list = osp.join(datapath, 'groundtruth.txt')
    elif osp.isfile(osp.join(datapath, 'pose.txt')):
        pose_list = osp.join(datapath, 'pose.txt')
    else:
        return None, None, None

    image_list = osp.join(datapath, 'rgb.txt')
    depth_list = osp.join(datapath, 'depth.txt')

    def parse_list(filepath, skiprows=0):
        return np.loadtxt(filepath, delimiter=' ', dtype=np.str_,
                          skiprows=skiprows)

    def associate_frames(tstamp_image, tstamp_depth, tstamp_pose,
                         max_dt=0.08):
        associations = []
        for i, t in enumerate(tstamp_image):
            j = np.argmin(np.abs(tstamp_depth - t))
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt and
                    np.abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
        return associations

    image_data = parse_list(image_list)
    depth_data = parse_list(depth_list)
    pose_data = parse_list(pose_list, skiprows=1)
    pose_vecs = pose_data[:, 1:].astype(np.float64)

    tstamp_image = image_data[:, 0].astype(np.float64)
    tstamp_depth = depth_data[:, 0].astype(np.float64)
    tstamp_pose = pose_data[:, 0].astype(np.float64)
    associations = associate_frames(tstamp_image, tstamp_depth, tstamp_pose)

    images, poses, depths = [], [], []
    for (i, j, k) in associations:
        images.append(os.path.join(datapath, image_data[i, 1]))
        depths.append(os.path.join(datapath, depth_data[j, 1]))
        poses.append(pose_vecs[k])

    return images, depths, poses
