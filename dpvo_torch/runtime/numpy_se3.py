"""Host-side (NumPy) SE3 helpers.

The functions of dpvo_tpu/runtime/numpy_se3.py that DeviceVO needs on the
host (pure numpy; copied so this package never imports the JAX package):
terminate() fills in the poses of non-keyframes with them, point_cloud()
maps patch centers to world points. Layout: (..., 7) [t, q].
"""
from __future__ import annotations

import numpy as np


def quat_rotate(q, v):
    qv, qw = q[..., :3], q[..., 3:4]
    uv = 2.0 * np.cross(qv, v)
    return v + qw * uv + np.cross(qv, uv)


def quat_mul(a, b):
    x1, y1, z1, w1 = [a[..., i] for i in range(4)]
    x2, y2, z2, w2 = [b[..., i] for i in range(4)]
    return np.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], axis=-1)


def quat_inv(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def inv(g):
    qinv = quat_inv(g[..., 3:7])
    return np.concatenate([-quat_rotate(qinv, g[..., :3]), qinv], axis=-1)


def mul(a, b):
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    t = a[..., :3] + quat_rotate(a[..., 3:7], b[..., :3])
    return np.concatenate([t, q], axis=-1)
