"""RANSAC-Umeyama Sim3 estimation (NumPy, vectorized).

Copy of dpvo_tpu/loop_closure/optim.py (numpy only; copied so this package
never imports the JAX package), which replaces the reference's numba-jit
umeyama_alignment / ransac_umeyama (dpvo/loop_closure/optim_utils.py:
64-150) with batched NumPy: all RANSAC hypotheses are solved with one
batched 3x3 SVD. ransac_umeyama draws from the caller's generator, so a
seeded run closes a loop with the same Sim3 every time.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(x, y):
    """Least-squares Sim3: y ~ c R x + t. x, y: (m, n). Returns (R, t, c)."""
    m, n = x.shape
    mean_x = x.mean(axis=1)
    mean_y = y.mean(axis=1)
    sigma_x = ((x - mean_x[:, None]) ** 2).sum() / n
    cov = (y - mean_y[:, None]) @ (x - mean_x[:, None]).T / n
    u, d, v = np.linalg.svd(cov)
    if np.count_nonzero(d > np.finfo(d.dtype).eps) < m - 1:
        return None, None, None
    s = np.eye(m)
    if np.linalg.det(u) * np.linalg.det(v) < 0.0:
        s[m - 1, m - 1] = -1
    r = u @ s @ v
    c = np.trace(np.diag(d) @ s) / sigma_x
    t = mean_y - c * (r @ mean_x)
    return r, t, c


def _batched_umeyama(xs, ys):
    """xs, ys: (B, 3, k) sample sets -> R (B,3,3), t (B,3), c (B,)."""
    k = xs.shape[2]
    mx = xs.mean(axis=2, keepdims=True)
    my = ys.mean(axis=2, keepdims=True)
    xc = xs - mx
    yc = ys - my
    sigma_x = (xc ** 2).sum(axis=(1, 2)) / k
    cov = np.einsum('bik,bjk->bij', yc, xc) / k
    u, d, v = np.linalg.svd(cov)
    det = np.linalg.det(u) * np.linalg.det(v)
    s = np.tile(np.eye(3), (len(xs), 1, 1))
    s[det < 0, 2, 2] = -1
    r = u @ s @ v
    c = np.einsum('bii->b', d[:, :, None] * s) / np.maximum(sigma_x, 1e-12)
    t = my[:, :, 0] - c[:, None] * np.einsum('bij,bj->bi', r, mx[:, :, 0])
    return r, t, c


def ransac_umeyama(src_points, dst_points, rng, iterations=400,
                   threshold=0.1):
    """(N,3),(N,3) -> (R, t, s, num_inliers). Mirrors optim_utils.py:117-150
    but evaluates all hypotheses in one batch; the minimal sets are drawn
    from `rng` (a np.random.RandomState)."""
    N = src_points.shape[0]
    if N < 3:
        return None, None, None, 0

    idx = np.stack([rng.choice(N, 3, replace=False)
                    for _ in range(iterations)])
    xs = src_points[idx].transpose(0, 2, 1)       # (B, 3, 3)
    ys = dst_points[idx].transpose(0, 2, 1)

    with np.errstate(all='ignore'):
        R, t, c = _batched_umeyama(xs, ys)

    # apply all hypotheses: (B, N, 3)
    transformed = np.einsum('bij,nj->bni', R * c[:, None, None], src_points) \
        + t[:, None, :]
    dist = np.linalg.norm(transformed - dst_points[None], axis=-1)
    inlier_mask = dist < threshold
    inliers = inlier_mask.sum(axis=1)
    best = int(np.argmax(inliers))
    if inliers[best] < 3:
        return None, None, None, 0

    mask = inlier_mask[best]
    r, tt, s = umeyama_alignment(src_points[mask].T, dst_points[mask].T)
    return r, tt, s, int(inliers[best])


def rotmat_to_quat(R):
    """(3,3) -> [qx, qy, qz, qw]."""
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    w = max(w, 1e-8)
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    q = np.array([x, y, z, w], np.float32)
    return q / np.linalg.norm(q)


def make_sim3(rot, t, s):
    """(R, t, s) -> (8,) [t, q, s] Sim3 vector (optim_utils.py:10-13)."""
    return np.concatenate([np.asarray(t, np.float32),
                           rotmat_to_quat(rot),
                           np.array([s], np.float32)])
