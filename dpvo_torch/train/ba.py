"""Differentiable bundle adjustment for training.

Port of dpvo_tpu/train/ba.py (reference pure-PyTorch training BA,
dpvo/ba.py:86-182): center residuals with the training validity rules (r <
250 px, bounds, Z > 0.2), the damped Schur complement with ep = 10 and
lmbda = 1e-4, pose retraction with the first `fixedp` poses anchored, the
inverse-depth clamp [1e-3, 10]. Gradients flow from the Gauss-Newton step
back into `target` and `weight` (the network's outputs) through
cholesky_ex / cholesky_solve, which autograd differentiates.

A window whose system is not positive definite, or whose step is not
finite, gets a zero update, as in dpvo_tpu; there its gradient is NaN (the
cotangent 0 meets the NaN factor), here it is zero: the factor that enters
the solve is the identity where cholesky_ex failed, as the reference's
CholeskySolver returns zeros forward and backward (dpvo/ba.py:12-37).
"""
from __future__ import annotations

import torch

from .. import lie
from ..ba import _gather_blocks


def _linearize_train(poses, xy, depth, intrinsics, target, weight,
                     ii, jj, kk, bounds):
    """Training-flavour linearization (validity rules of dpvo/ba.py:92-112):
    r, w (E, 2), Ji / Jj (E, 2, 6), Jz (E, 2)."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    tij = Gij[..., :3]

    xn = (xy[kk, 0] - cx) / fx
    yn = (xy[kk, 1] - cy) / fy
    Xi = torch.stack([xn, yn, torch.ones_like(xn), depth[kk]], dim=-1)
    Xj = lie.se3_act4(Gij, Xi)
    X, Y, Z, Hh = Xj.unbind(-1)

    dclamp = 1.0 / torch.clamp(Z, min=0.1)
    x1 = fx * X * dclamp + cx
    y1 = fy * Y * dclamp + cy

    r = target - torch.stack([x1, y1], dim=-1)

    v = ((Z > 0.2) & (torch.linalg.vector_norm(r, dim=-1) < 250) &
         (x1 > bounds[0]) & (y1 > bounds[1]) &
         (x1 < bounds[2]) & (y1 < bounds[3])).float()

    big = Z.abs() > 0.2
    d = torch.where(big, 1.0 / torch.where(big, Z, 1.0), 0.0)
    d2 = d * d
    o = torch.zeros_like(X)
    Jj = torch.stack([
        fx * Hh * d, o, -fx * X * Hh * d2, -fx * X * Y * d2,
        fx * (1 + X * X * d2), -fx * Y * d,
        o, fy * Hh * d, -fy * Y * Hh * d2, -fy * (1 + Y * Y * d2),
        fy * (X * Y * d2), fy * X * d,
    ], dim=-1).reshape(X.shape + (2, 6))
    Jz = torch.stack([
        fx * (tij[..., 0] * d - tij[..., 2] * (X * d2)),
        fy * (tij[..., 1] * d - tij[..., 2] * (Y * d2)),
    ], dim=-1)
    Ji = -lie.se3_adjT(Gij[..., None, :], Jj)

    return v[..., None] * r, v[..., None] * weight, Ji, Jj, Jz


def bundle_adjust_train(poses, xy, depth, intrinsics, target, weight,
                        ii, jj, kk, bounds, *, W, PC, lmbda=1e-4, ep=10.0,
                        fixedp=1, structure_only=False):
    """One differentiable Gauss-Newton step (the reference applies it twice
    per update iteration, net.py:259-261).

    poses (N, 7); xy (Np, 2) patch centers; depth (Np,); intrinsics (4,);
    target / weight (E, 2); ii / jj / kk (E,) int64; bounds (4,) [x_lo,
    y_lo, x_hi, y_hi]. W >= N - fixedp pose slots, PC <= Np patch slots.
    Returns new (poses, depth); the inputs are not written."""
    r, w, Ji, Jj, Jz = _linearize_train(
        poses, xy, depth, intrinsics, target, weight, ii, jj, kk, bounds)
    B, Em, C, v, u, touched = _gather_blocks(
        r, w, Ji, Jj, Jz, ii, jj, kk, fixedp, 0, W, PC)

    Q = 1.0 / (C + lmbda)

    if structure_only:
        dZ = Q * u
        dZ = torch.where(torch.isfinite(dZ).all(), dZ, 0.0)
        dX = None
    else:
        S = B.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
        E2 = Em.permute(0, 2, 1).reshape(6 * W, PC)
        EQ = E2 * Q[None, :]
        S = S - EQ @ E2.T
        y = v.reshape(6 * W) - EQ @ u
        # training damping (dpvo/ba.py:73): A += (ep + lm * A) * I
        S = S + torch.diag(ep + lmbda * torch.diagonal(S))
        L, info = torch.linalg.cholesky_ex(S)
        factored = info == 0
        L = torch.where(factored, L,
                        torch.eye(6 * W, dtype=L.dtype, device=L.device))
        dX = torch.cholesky_solve(y[:, None], L)[:, 0]
        dZ = Q * (u - E2.T @ dX)
        dX = dX.reshape(W, 6)
        # graceful failure on a non-PD window: a zero update
        ok = factored & torch.isfinite(dX).all() & torch.isfinite(dZ).all()
        dX = torch.where(ok, dX, 0.0)
        dZ = torch.where(ok, dZ, 0.0)

    # depth retraction + training clamp (dpvo/ba.py:176)
    add = torch.where(touched > 0, dZ, 0.0)
    if PC < depth.shape[0]:
        add = torch.cat([add, add.new_zeros(depth.shape[0] - PC)])
    depth = torch.clamp(depth + add, 1e-3, 10.0)

    if not structure_only:
        # slots fixedp .. fixedp + W - 1; slots past N are dropped
        n = min(W, poses.shape[0] - fixedp)
        new_win = lie.se3_retr(poses[fixedp:fixedp + n], dX[:n])
        poses = torch.cat([poses[:fixedp], new_win, poses[fixedp + n:]])

    return poses, depth
