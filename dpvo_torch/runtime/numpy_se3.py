"""Host-side (NumPy) SE3 helpers.

Copy of dpvo_tpu/runtime/numpy_se3.py (pure numpy; copied so this package
never imports the JAX package). The hybrid runtime (runtime/dpvo.py) makes
its small per-frame decisions with them against its host mirrors: motion
model extrapolation (log / exp), the keyframe flow test (flow_mag), the
removed-frame deltas (identity, mul, inv); DeviceVO's terminate() and the
point clouds use mul, inv, act and quat_rotate. Layout: (..., 7) [t, q].
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


def act(g, p):
    """Apply SE3 [t, q] (..., 7) to points p (..., 3)."""
    return quat_rotate(g[..., 3:7], p) + g[..., :3]


def _hat(p):
    a, b, c = p[..., 0], p[..., 1], p[..., 2]
    o = np.zeros_like(a)
    m = np.stack([o, -c, b, c, o, -a, -b, a, o], axis=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def exp(xi):
    tau, phi = xi[..., :3], xi[..., 3:6]
    theta_sq = np.sum(phi * phi, axis=-1, keepdims=True)
    theta = np.sqrt(theta_sq)
    small = theta_sq < 1e-8
    with np.errstate(invalid='ignore', divide='ignore'):
        imag = np.where(small, 0.5 - theta_sq / 48.0,
                        np.sin(0.5 * theta) / np.where(small, 1, theta))
        real = np.where(small, 1.0 - theta_sq / 8.0, np.cos(0.5 * theta))
        q = np.concatenate([imag * phi, real], axis=-1)
        a = np.where(small, 0.5 - theta_sq / 24.0,
                     (1 - np.cos(theta)) / np.where(small, 1, theta_sq))
        b = np.where(small, 1 / 6.0 - theta_sq / 120.0,
                     (theta - np.sin(theta)) /
                     np.where(small, 1, theta_sq * theta))
    hat = _hat(phi)
    hat2 = phi[..., :, None] * phi[..., None, :] - theta_sq[..., None] * np.eye(3)
    V = np.eye(3) + a[..., None] * hat + b[..., None] * hat2
    t = np.einsum('...ij,...j->...i', V, tau)
    return np.concatenate([t, q], axis=-1).astype(xi.dtype)


def log(g):
    t, q = g[..., :3], g[..., 3:7]
    qv, qw = q[..., :3], q[..., 3:4]
    sgn = np.where(qw < 0, -1.0, 1.0)
    qv, qw = qv * sgn, qw * sgn
    n_sq = np.sum(qv * qv, axis=-1, keepdims=True)
    n = np.sqrt(np.maximum(n_sq, 1e-24))
    theta = 2.0 * np.arctan2(n, qw)
    small = n_sq < 1e-12
    scale = np.where(small, 2.0 / np.maximum(qw, 1e-8), theta / n)
    phi = scale * qv
    theta_sq = np.sum(phi * phi, axis=-1, keepdims=True)
    th = np.sqrt(np.maximum(theta_sq, 1e-24))
    half = 0.5 * th
    with np.errstate(invalid='ignore', divide='ignore'):
        c = np.where(theta_sq < 1e-8, 1 / 12.0 + theta_sq / 720.0,
                     (1.0 - half * np.cos(half) / np.maximum(np.sin(half), 1e-12))
                     / np.where(theta_sq < 1e-8, 1, theta_sq))
    hat = _hat(phi)
    hat2 = phi[..., :, None] * phi[..., None, :] - theta_sq[..., None] * np.eye(3)
    Vinv = np.eye(3) - 0.5 * hat + c[..., None] * hat2
    tau = np.einsum('...ij,...j->...i', Vinv, t)
    return np.concatenate([tau, phi], axis=-1).astype(g.dtype)


def identity(shape=()):
    g = np.zeros(tuple(shape) + (7,), np.float32)
    g[..., 6] = 1.0
    return g


def flow_mag(poses, centers, depth, intrinsics, ii, jj, kk, beta=0.5):
    """Blended patch-center flow magnitude (host mirror of pops.flow_mag).

    poses (N,7), centers (Np,2), depth (Np,), intrinsics (4,). Evaluated at
    patch centers only — the keyframe decision in the reference averages over
    the P x P grid of nearly identical values (dpvo.py:257-264), so the
    center value is an accurate stand-in.
    Returns (flow (E,), valid (E,) bool).
    """
    fx, fy, cx, cy = intrinsics
    xn = (centers[kk, 0] - cx) / fx
    yn = (centers[kk, 1] - cy) / fy
    X0 = np.stack([xn, yn, np.ones_like(xn), depth[kk]], axis=-1)

    def project(g, tonly=False):
        if tonly:
            x = X0[..., :3] + X0[..., 3:4] * g[..., :3]
            Xj = np.concatenate([x, X0[..., 3:4]], axis=-1)
        else:
            x = quat_rotate(g[..., 3:7], X0[..., :3]) + X0[..., 3:4] * g[..., :3]
            Xj = np.concatenate([x, X0[..., 3:4]], axis=-1)
        d = 1.0 / np.maximum(Xj[..., 2], 0.1)
        return np.stack([fx * Xj[..., 0] * d + cx,
                         fy * Xj[..., 1] * d + cy], axis=-1), Xj[..., 2]

    Gij = mul(poses[jj], inv(poses[ii]))
    coords0 = np.stack([centers[kk, 0], centers[kk, 1]], axis=-1)
    coords1, Z1 = project(Gij)
    coords2, _ = project(Gij, tonly=True)

    flow1 = np.linalg.norm(coords1 - coords0, axis=-1)
    flow2 = np.linalg.norm(coords2 - coords0, axis=-1)
    return beta * flow1 + (1 - beta) * flow2, Z1 > 0.2
