"""Global bundle adjustment with pair-block-compressed E (DPV-SLAM backend).

Port of dpvo_tpu/ba_global.py, the reference's fastba.BA(eff_impl=True)
(dpvo/fastba/block_e.cu:43-300, ba_cuda.cu:538-550): the pose-depth
coupling matrix E is never dense. Edges come in groups that share a (source
frame i, target frame j) pair and cover at most M patches of frame i, so E
is kept as one 6-vector per (pair, patch slot):

    E_lookup[g * M + k]  --  column block of pair g, patch slot k

EQE^T is a batch of (6 x M) diag(Q) (M x 6) products over the host-built
pair-triple table (i, j1, j2, g1, g2) (the reference's `index_tensor`,
block_e.cu:104-125), summed into the (W, W) pose blocks with index_add_.

The step runs in f64 on the f32 state and rounds its result back to f32.
In f32 (dpvo_tpu's einsums at Precision.HIGHEST, the reference's float
kernels) the pose blocks B reach ~1e6 and B - EQE^T cancels most of them,
so two f32 orders of the same sums land ~1e-4 apart in the poses
(tests/test_torch_ba_global.py); in f64 no TF32 path is taken either.
dpvo_tpu accumulated the edges in chunks to bound XLA's transients; the
port takes them in one pass (E ~ 2e5 edges at 640x480 are tens of MB of
blocks) and does not pad the edge set to a bucket. The pose window W (a
multiple of 128 frames) and the depth window PC (a multiple of 128 M
patches) are dpvo_tpu's buckets, since they set which rows the solve
touches.
"""
from __future__ import annotations

import numpy as np
import torch

from . import lie
from .ba import _linearize
from .ba_pairs import _seg as _seg32
from .transfer import upload


def build_pair_tables(ii, jj, kk, M):
    """Host index tables (EfficentE's CPU setup, block_e.cu:43-145).

    Returns a dict of numpy arrays:
      gx, gs        (E,) int32 each edge's (i, j) pair and its (i, i) pair
      pair_i, pair_j (G,) int32 frames of each pair (j == i: self pair),
                    sorted by (i, j)
      trip_i, trip_j1, trip_j2, trip_g1, trip_g2 (R,) int32 the EQE^T
                    table: for every source frame, every ordered pair of its
                    pairs (g1-major)
      n_pairs G, n_rows R
    Equal, row order included, to dpvo_tpu's, which builds the triples in a
    Python loop."""
    ii = np.asarray(ii, np.int64)
    jj = np.asarray(jj, np.int64)
    n_frames = int(max(ii.max(), jj.max())) + 1 if len(ii) else 1
    key_x = ii * n_frames + jj
    key_s = ii * n_frames + ii
    uniq, inv = np.unique(np.concatenate([key_x, key_s]), return_inverse=True)
    E = len(ii)
    pair_i = (uniq // n_frames).astype(np.int32)
    pair_j = (uniq % n_frames).astype(np.int32)

    # the keys are sorted, so each source frame's pairs are one run; its
    # triples are the run's pairs squared, g1-major
    G = len(uniq)
    starts = np.flatnonzero(np.r_[True, pair_i[1:] != pair_i[:-1]])
    counts = np.diff(np.r_[starts, G])
    sq = counts * counts
    run = np.repeat(np.arange(len(starts)), sq)
    off = np.arange(sq.sum()) - np.repeat(np.cumsum(sq) - sq, sq)
    g1 = (starts[run] + off // counts[run]).astype(np.int32)
    g2 = (starts[run] + off % counts[run]).astype(np.int32)
    return dict(
        gx=inv[:E].astype(np.int32), gs=inv[E:].astype(np.int32),
        pair_i=pair_i, pair_j=pair_j,
        trip_i=pair_i[g1], trip_j1=pair_j[g1], trip_j2=pair_j[g2],
        trip_g1=g1, trip_g2=g2, n_pairs=G, n_rows=len(g1))


def _seg(vals, ids, valid, num):
    return _seg32(vals, ids, valid, num, torch.float64)


def _edge_blocks(poses, xy, depth, intrinsics, target, weight, ii, jj, kk,
                 gx, gs, t0, W, PC, G, M):
    """Linearize every edge and sum its blocks: B (W, W, 6, 6), E_lookup
    (G * M, 6), C, u, touched (PC,), v (W, 6). Pose terms outside the
    window [t0, t0 + W) and depth terms of patches >= PC are dropped; E is
    kept for every edge."""
    mask = torch.ones_like(ii, dtype=torch.bool)
    r, w, Ji, Jj, Jz = _linearize(poses, xy, depth, intrinsics, target,
                                  weight, ii, jj, kk, mask)
    wi = ii - t0
    wj = jj - t0
    vi = (wi >= 0) & (wi < W)
    vj = (wj >= 0) & (wj < W)
    vk = kk < PC

    def JtWJ(A, B):                     # (E, 2, a), (E, 2, b) -> (E, a, b)
        return torch.einsum('era,erb->eab', A * w[..., None], B)

    Bij = JtWJ(Ji, Jj)
    B = _seg(JtWJ(Ji, Ji), wi * W + wi, vi, W * W)
    B = B + _seg(Bij, wi * W + wj, vi & vj, W * W)
    B = B + _seg(Bij.transpose(-1, -2), wj * W + wi, vi & vj, W * W)
    B = B + _seg(JtWJ(Jj, Jj), wj * W + wj, vj, W * W)

    wJz = w * Jz
    slot = kk % M
    El = _seg((Ji * wJz[..., None]).sum(1), gs * M + slot, mask, G * M)
    El = El + _seg((Jj * wJz[..., None]).sum(1), gx * M + slot, mask, G * M)
    C = _seg((Jz * wJz).sum(-1), kk, vk, PC)
    u = _seg((Jz * w * r).sum(-1), kk, vk, PC)
    wr = (w * r)[..., None]
    v = _seg((Ji * wr).sum(1), wi, vi, W) + _seg((Jj * wr).sum(1), wj, vj, W)
    touched = _seg((w.sum(-1) > 0).float(), kk, vk, PC)
    return B.reshape(W, W, 6, 6), El, C, v, u, touched


def _eqet(ElM, Q, trip, t0, W, M):
    """EQE^T (W, W, 6, 6) over the pair-triple table (block_e.cu:147-202):
    per row, E[g1]^T diag(Q of frame i's patches) E[g2] into block
    (j1 - t0, j2 - t0)."""
    q = Q.view(-1, M)[trip['trip_i']]                            # (R, M)
    out = torch.einsum('rmi,rmj->rij', ElM[trip['trip_g1']] * q[..., None],
                       ElM[trip['trip_g2']])
    w1 = trip['trip_j1'] - t0
    w2 = trip['trip_j2'] - t0
    ok = (w1 >= 0) & (w1 < W) & (w2 >= 0) & (w2 < W)
    return _seg(out, w1 * W + w2, ok, W * W).reshape(W, W, 6, 6)


def _step(poses, xy, depth, intrinsics, target, weight, lmbda, ii, jj, kk,
          tabs, t0, t1, W, PC, M):
    """One Gauss-Newton step: Schur complement over the inverse depths,
    damping S += diag(1e-4 diag(S) + 1), Cholesky; a zero update where the
    factorization fails or the update is not finite; retraction of the
    live slots [t0, min(t0 + W, t1)); depth update with the clamps (> 20
    -> 1, >= 1e-4) on the touched patches of [0, PC)."""
    G = tabs['pair_i'].shape[0]
    B, El, C, v, u, touched = _edge_blocks(
        poses, xy, depth, intrinsics, target, weight, ii, jj, kk,
        tabs['gx'], tabs['gs'], t0, W, PC, G, M)
    ElM = El.reshape(G, M, 6)
    Q = 1.0 / (C + lmbda)
    S = (B - _eqet(ElM, Q, tabs, t0, W, M)).permute(0, 2, 1, 3).reshape(
        6 * W, 6 * W)

    # EQu: each pair's j row gets E_lookup[g] . (Q u) over its patches
    pair_i, wj = tabs['pair_i'], tabs['pair_j'] - t0
    vj = (wj >= 0) & (wj < W)
    qu = (Q * u).view(-1, M)[pair_i]                             # (G, M)
    EQu = _seg((ElM * qu[..., None]).sum(1), wj, vj, W)
    y = (v - EQu).reshape(6 * W)

    S = S + torch.diag(1e-4 * torch.diagonal(S) + 1.0)
    L, info = torch.linalg.cholesky_ex(S)
    dX = torch.cholesky_solve(y[:, None], L)[:, 0].reshape(W, 6)

    # E^T dX: patch k of pair g gets E_lookup[g, k] . dX[j - t0]
    dxg = torch.where(vj[:, None], dX[wj.clamp(0, W - 1)], 0.0)  # (G, 6)
    slots = pair_i[:, None] * M + torch.arange(M, device=pair_i.device)
    EtdX = _seg((ElM * dxg[:, None, :]).sum(-1).reshape(-1),
                slots.reshape(-1), slots.reshape(-1) < PC, PC)
    dZ = Q * (u - EtdX)

    ok = (info == 0) & torch.isfinite(dX).all() & torch.isfinite(dZ).all()
    dX = torch.where(ok, dX, 0.0)
    dZ = torch.where(ok, dZ, 0.0)

    hi = min(t0 + W, t1, poses.shape[0])
    poses = poses.clone()
    if hi > t0:
        poses[t0:hi] = lie.se3_retr(poses[t0:hi], dX[:hi - t0])
    d = depth[:PC]
    dnew = d + dZ
    dnew = torch.where(dnew > 20.0, 1.0, dnew).clamp(min=1e-4)
    depth = depth.clone()
    depth[:PC] = torch.where(touched > 0, dnew, d)
    return poses, depth


def _bucket(n, step):
    return max(step, -(-n // step) * step)


def global_ba(poses, xy, depth, intrinsics, target, weight, ii, jj, kk,
              t0, t1, M, iterations=2, lmbda=1e-4):
    """Global bundle adjustment over a full edge set (active + inactive).

    poses (N, 7), xy (Np, 2) patch centers, depth (Np,), intrinsics (4,)
    f32 tensors; target / weight (E, 2) tensors or arrays; ii / jj / kk (E,)
    host int arrays; host ints t0, t1 (pose window [t0, t1)). Returns new
    (poses, depth); inputs untouched. Mirrors fastba.BA(..., eff_impl=True)
    (ba_cuda.cu:433-582). With device tensors it only queues device work:
    the index tables go up without waiting (transfer.upload) and nothing
    is read back."""
    if len(ii) == 0:
        return poses, depth
    dev, dt = poses.device, poses.dtype
    tabs = build_pair_tables(ii, jj, kk, M)
    W = _bucket(int(t1 - t0), 128)
    PC = min(_bucket(int(t1) * M, 128 * M), depth.shape[0])
    tabs = {k: (upload(v, dev, np.int64) if isinstance(v, np.ndarray)
                else v) for k, v in tabs.items()}
    ii, jj, kk = (upload(a, dev, np.int64) for a in (ii, jj, kk))
    f64 = [torch.as_tensor(a, device=dev).double()
           for a in (poses, xy, depth, intrinsics, target, weight)]
    poses, xy, depth, intrinsics, target, weight = f64
    for _ in range(iterations):
        poses, depth = _step(poses, xy, depth, intrinsics, target, weight,
                             lmbda, ii, jj, kk, tabs, int(t0), int(t1), W, PC,
                             M)
    return poses.to(dt), depth.to(dt)
