"""Pair-blocked bundle adjustment over the device-resident edge table.

Port of dpvo_tpu/ba_pairs.py. Edges come per (source frame i, target frame
j) pair covering all M patches of frame i (reference dpvo.py:362-375), so
every gather is a contiguous M-block and the Hessian scatters run over
pairs, not edges. Same math, gating and damping as the reference
(ba_cuda.cu:232-376); row gathers are index_select and segment sums
index_add_ (the one-hot matmuls of dpvo_tpu were a TPU workaround).

The window bounds t0, t1 and fbase are 0-d integer tensors on the device,
as in dpvo_tpu (the keyframe count lives there, runtime/device_vo.py), or
host ints. Either way the windows are gathers and scatters of a fixed
number of rows at device indices: nothing is read back.
"""
from __future__ import annotations

import torch

from . import lie


def pair_centers(centers, pi, M):
    """(GP, M, 2) per-pair patch centers; centers is (NF, 2*M) frame-major."""
    return centers[pi.clamp(min=0)].reshape(pi.shape[0], M, 2)


def pair_depth(depth, pi, M):
    return depth.view(-1, M)[pi.clamp(min=0)]


def _linearize_pairs(poses, centers, depth, intr, target, weight,
                     pi, pj, pvalid, M):
    """Residuals + Jacobians at patch centers: r, w (GP, M, 2),
    Ji / Jj (GP, M, 2, 6), Jz (GP, M, 2)."""
    fx, fy, cx, cy = intr.unbind(0)
    Gi = poses[pi.clamp(min=0)]
    Gj = poses[pj.clamp(min=0)]
    Gij = lie.se3_mul(Gj, lie.se3_inv(Gi))                    # (GP, 7)
    tij = Gij[..., :3]

    xy = pair_centers(centers, pi, M)
    d = pair_depth(depth, pi, M)
    xn = (xy[..., 0] - cx) / fx
    yn = (xy[..., 1] - cy) / fy
    Xi = torch.stack([xn, yn, torch.ones_like(xn), d], dim=-1)
    Xj = lie.se3_act4(Gij[:, None, :], Xi)

    X, Y, Z, Wh = Xj.unbind(-1)
    big = Z >= 0.2
    dd = torch.where(big, 1.0 / torch.where(big, Z, 1.0), 0.0)
    d2 = dd * dd
    Zs = torch.where(Z.abs() < 1e-8, 1e-8, Z)
    x1 = fx * (X / Zs) + cx
    y1 = fy * (Y / Zs) + cy

    rx = target[..., 0] - x1
    ry = target[..., 1] - y1
    in_bounds = ((torch.sqrt(rx * rx + ry * ry) < 128) & (Z > 0.2) &
                 (x1 > -64) & (y1 > -64) &
                 (x1 < 2 * cx + 64) & (y1 < 2 * cy + 64))
    gate = (in_bounds & pvalid[:, None]).float()
    r = torch.stack([rx, ry], dim=-1)
    w = gate[..., None] * weight

    o = torch.zeros_like(X)
    Jj = torch.stack([
        fx * Wh * dd, o, -fx * X * Wh * d2, -fx * X * Y * d2,
        fx * (1 + X * X * d2), -fx * Y * dd,
        o, fy * Wh * dd, -fy * Y * Wh * d2, -fy * (1 + Y * Y * d2),
        fy * (X * Y * d2), fy * X * dd,
    ], dim=-1).reshape(X.shape + (2, 6))
    Jz = torch.stack([
        fx * (tij[:, None, 0] * dd - tij[:, None, 2] * (X * d2)),
        fy * (tij[:, None, 1] * dd - tij[:, None, 2] * (Y * d2)),
    ], dim=-1)
    Ji = -lie.se3_adjT(Gij[:, None, None, :], Jj)
    return r, w, Ji, Jj, Jz


def _seg(vals, ids, valid, num, dtype=torch.float32):
    """Segment sum of per-pair rows into `num` slots, in `dtype`; rows with
    valid False land in a spare slot that is dropped."""
    flat = vals.reshape(ids.shape[0], -1).to(dtype)
    out = torch.zeros((num + 1, flat.shape[1]), dtype=dtype,
                      device=flat.device)
    out.index_add_(0, torch.where(valid, ids, num), flat)
    return out[:num].reshape((num,) + vals.shape[1:])


def clamp_start(start, size, total):
    """Start index of a length-`size` window clamped into [0, total - size]
    (the semantics of lax.dynamic_slice / dynamic_update_slice). `start` is
    a host int or an integer tensor; a tensor stays one (no read)."""
    if isinstance(start, torch.Tensor):
        return start.clamp(max=total - size).clamp(min=0)
    return max(0, min(start, total - size))


def window_rows(start, size, total, device):
    """(size,) int64 rows of the length-`size` window at `start`, clamped
    into the buffer as clamp_start does (size <= total): distinct rows, so
    an index_copy_ back to them is deterministic."""
    return clamp_start(start, size, total) + torch.arange(size, device=device)


def solve_step(poses, depth, B, Em, C, v, u, touched, lmbda, t0, t1, s):
    """One damped Gauss-Newton step from the normal-equation blocks: the
    dense Schur complement over the per-patch inverse depths, damping
    S += diag(1e-4 diag(S) + 1) (ba_cuda.cu:546), Cholesky, retraction of
    the live pose slots [t0, min(t0 + W, t1, N)), depth update + clamps
    (d > 20 -> 1, d >= 1e-4; ba_cuda.cu:209-229) on the touched slots of
    the depth window [s, s + PC). B (W, W, 6, 6), Em (W, PC, 6), C / u /
    touched (PC,), v (W, 6); t0, t1, s host ints or 0-d integer tensors.
    Returns new (poses, depth); inputs untouched."""
    W, PC = B.shape[0], C.shape[0]
    N = poses.shape[0]
    Q = 1.0 / (C + lmbda)
    S = B.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    E2 = Em.permute(0, 2, 1).reshape(6 * W, PC)
    EQ = E2 * Q[None, :]
    S = S - EQ @ E2.T
    y = v.reshape(6 * W) - EQ @ u
    S = S + torch.diag(1e-4 * torch.diagonal(S) + 1.0)
    # a non-PD window yields info > 0 (cholesky_ex does not raise);
    # together with the finiteness check it zeroes the update instead
    # of propagating garbage (reference dpvo/ba.py:12-37 posture)
    L, info = torch.linalg.cholesky_ex(S)
    dX = torch.cholesky_solve(y[:, None], L)[:, 0]
    dZ = Q * (u - E2.T @ dX)
    ok = (info == 0) & torch.isfinite(dX).all() & torch.isfinite(dZ).all()
    dX = torch.where(ok, dX, 0.0).reshape(W, 6)
    dZ = torch.where(ok, dZ, 0.0)

    # window slots t0 + [0, W) that are live (< t1) and in the buffer: a
    # gather of min(W, N) rows around them, the retraction where live, the
    # rows written back
    rows = window_rows(t0, min(W, N), N, poses.device)
    k = rows - t0                                   # each row's window slot
    live = (k >= 0) & (k < W) & (rows < t1)
    old = poses.index_select(0, rows)
    new = lie.se3_retr(old, dX.index_select(0, k.clamp(0, W - 1)))
    poses = poses.index_copy(0, rows, torch.where(live[:, None], new, old))
    return poses, retract_depth(depth, dZ, touched, s)


def retract_depth(depth, dZ, touched, s):
    """depth[s:s + PC] += dZ on the touched slots, then the clamps (d > 20
    -> 1, d >= 1e-4; ba_cuda.cu:209-229). s: a host int or a 0-d integer
    tensor, clamped into the buffer as clamp_start does. Returns a new
    tensor."""
    rows = window_rows(s, dZ.shape[0], depth.shape[0], depth.device)
    dslot = depth.index_select(0, rows)
    dnew = dslot + dZ
    dnew = torch.where(dnew > 20.0, 1.0, dnew).clamp(min=1e-4)
    return depth.index_copy(0, rows, torch.where(touched > 0, dnew, dslot))


def bundle_adjust_pairs(poses, centers, depth, intr, target, weight, lmbda,
                        pi, pj, pvalid, t0, t1, fbase,
                        *, M, W, PCF, iterations=2):
    """Windowed Gauss-Newton over a pair-blocked edge table.

    poses (N, 7); centers (N, 2*M); depth (N*M,); intr (4,); target / weight
    (GP, M, 2); pi / pj (GP,) frame ids; pvalid (GP,) bool; t0, t1 (pose
    window [t0, t1)) and fbase (first frame of the PCF-frame patch window),
    each a 0-d integer tensor on the device or a host int; W pose slots.
    Returns new (poses, depth); inputs untouched."""
    PC = PCF * M
    for _ in range(iterations):
        r, w, Ji, Jj, Jz = _linearize_pairs(
            poses, centers, depth, intr, target, weight, pi, pj, pvalid, M)

        wi = pi - t0
        wj = pj - t0
        vi = (wi >= 0) & (wi < W) & pvalid
        vj = (wj >= 0) & (wj < W) & pvalid
        fi = pi - fbase
        vk = (fi >= 0) & (fi < PCF) & pvalid

        def JtWJ(A, B):
            return torch.einsum('gmra,gmrb->gab', A * w[..., None], B)

        Bii = JtWJ(Ji, Ji)
        Bij = JtWJ(Ji, Jj)
        Bjj = JtWJ(Jj, Jj)
        B = _seg(Bii, wi * W + wi, vi, W * W)
        B = B + _seg(Bij, wi * W + wj, vi & vj, W * W)
        B = B + _seg(Bij.transpose(-1, -2), wj * W + wi, vi & vj, W * W)
        B = B + _seg(Bjj, wj * W + wj, vj, W * W)
        B = B.reshape(W, W, 6, 6)

        wJz = w * Jz
        Eik = (Ji * wJz[..., None]).sum(2)                      # (GP, M, 6)
        Ejk = (Jj * wJz[..., None]).sum(2)
        Em = _seg(Eik, wi * PCF + fi, vi & vk, W * PCF)
        Em = Em + _seg(Ejk, wj * PCF + fi, vj & vk, W * PCF)
        Em = Em.reshape(W, PC, 6)

        C = _seg((Jz * wJz).sum(-1), fi, vk, PCF).reshape(PC)
        u = _seg((Jz * w * r).sum(-1), fi, vk, PCF).reshape(PC)
        touched = _seg((w.sum(-1) > 0).float(), fi, vk, PCF).reshape(PC)
        wr = (w * r)[..., None]
        v = _seg((Ji * wr).sum((1, 2)), wi, vi, W)
        v = v + _seg((Jj * wr).sum((1, 2)), wj, vj, W)

        s = clamp_start(fbase * M, PC, depth.shape[0])
        poses, depth = solve_step(poses, depth, B, Em, C, v, u, touched,
                                  lmbda, t0, t1, s)
    return poses, depth
