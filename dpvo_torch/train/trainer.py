"""Training: the unrolled VONet forward, the loss and the optimizer step.

Port of dpvo_tpu/train/trainer.py (reference train.py:44-171 and
VONet.forward, net.py:187-272): frames introduced one per unroll step after
the first 8, two differentiable BA steps per update, the flow loss (min
over patch pixels) + the scale-aligned relative pose loss, AdamW with a
linear one-cycle rate after a global-norm clip of 10.

Where it differs from dpvo_tpu:
  * the correlation is ops/corr_grad.py:corr_two_level_train, K1 forward
    and a backward that recomputes the taps (csrc/corr_backward.cu on the
    card), where dpvo_tpu differentiates the gather form;
  * the B sequences of a batch run one after another, each one's backward
    before the next (dpvo_tpu vmaps them); the step is eager, no jit;
    data parallelism is one process per card over torch.distributed
    (make_train_step's group, parallel/mesh.py) where dpvo_tpu shards the
    batch over a 'dp' mesh;
  * the two random regularizers draw from a torch.Generator seeded from the
    batch's `rng` ints, so they do not give jax.random's masks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .. import lie
from ..models.vonet import DIM, P
from ..ops.corr_grad import corr_two_level_train
from ..ops.patchify import extract_patches
from ..parallel.mesh import all_gather_cat, all_reduce_grads
from ..runtime.device_vo import _median
from .ba import bundle_adjust_train


# ---------------------------------------------------------------------------
# static edge schedule (copied from dpvo_tpu/train/trainer.py:43-90;
# reference net.py:208, 227-247)
# ---------------------------------------------------------------------------

def edge_schedule(T, M, steps):
    """Python-side schedule: per unroll step the (ii, jj, kk) arrays and the
    frame being introduced (or None). Shapes are static per step."""
    ii, jj, kk = [], [], []
    # initial graph: patches of frames < 8 x frames 0..7
    for k in range(8 * M):
        for j in range(8):
            kk.append(k)
            jj.append(j)
            ii.append(k // M)
    sched = []
    n = 8
    for s in range(steps):
        new_frame = None
        if s >= 8 and n < T:
            new_frame = n
            # edges: old patches -> new frame; new patches -> frames 0..n
            for k in range((n + 1) * M):
                if k < n * M:
                    kk.append(k)
                    jj.append(n)
                    ii.append(k // M)
            for k in range(n * M, (n + 1) * M):
                for j in range(n + 1):
                    kk.append(k)
                    jj.append(j)
                    ii.append(k // M)
            n += 1
        sched.append((np.array(ii, np.int32).copy(),
                      np.array(jj, np.int32).copy(),
                      np.array(kk, np.int32).copy(), new_frame, n))
    return sched


def _group_ids(ii, jj, kk):
    _, kk_ids = np.unique(kk, return_inverse=True)
    _, pair_ids = np.unique(ii.astype(np.int64) * 12345 + jj,
                            return_inverse=True)
    E = len(ii)
    ix = np.full(E, -1, np.int64)
    jx = np.full(E, -1, np.int64)
    order = np.lexsort((np.arange(E), jj, kk))
    sk = kk[order]
    same = sk[1:] == sk[:-1]
    ix[order[1:][same]] = order[:-1][same]
    jx[order[:-1][same]] = order[1:][same]
    return (kk_ids.astype(np.int32), pair_ids.astype(np.int32),
            ix.astype(np.int32), jx.astype(np.int32))


# ---------------------------------------------------------------------------
# forward unroll for one sequence
# ---------------------------------------------------------------------------

def _generator(rng):
    """A CPU torch.Generator seeded from the ints of a batch's `rng`."""
    seed = 0
    for v in np.asarray(rng).reshape(-1):
        seed = (seed << 32 | int(v) & 0xffffffff) % (1 << 63)
    return torch.Generator().manual_seed(seed)


def _transform_full(poses, patch_xy, depth, intr4, ii, jj, kk,
                    with_valid=False):
    """Every patch pixel of edge (ii, jj, kk) reprojected into frame jj:
    (E, P, P, 2); with_valid also (E, P, P) f32, 1 where Z > 0.2."""
    fx, fy, cx, cy = intr4.unbind(-1)
    xy = patch_xy[kk]
    d = depth[kk][:, None, None]
    xn = (xy[:, 0] - cx) / fx
    yn = (xy[:, 1] - cy) / fy
    X0 = torch.stack([xn, yn, torch.ones_like(xn), d.expand_as(xn)], dim=-1)
    Gij = lie.se3_mul(poses[jj], lie.se3_inv(poses[ii]))
    X1 = lie.se3_act4(Gij[:, None, None, :], X0)
    Z = torch.clamp(X1[..., 2], min=0.1)
    out = torch.stack([fx * X1[..., 0] / Z + cx,
                       fy * X1[..., 1] / Z + cy], dim=-1)
    if with_valid:
        return out, (X1[..., 2] > 0.2).float()
    return out


def vonet_forward(net, images, poses_gt, disps_gt, intrinsics, coords,
                  depth_init, sched, structure_only=False, rng=None,
                  corr_grad_keep=0.2, edge_dropout=0.1, gs_init=None):
    """Unrolled trajectory estimation for ONE sequence (dpvo_tpu
    vonet_forward); the compute dtype is the parameters' (bf16 under mixed
    precision, see make_train_step).

    images (T, H, W, 3) f32 raw [0, 255]; poses_gt (T, 7) world-to-camera;
    disps_gt (T, H/4, W/4) GT inverse depth; intrinsics (4,) full
    resolution; coords (T, M, 2) patch centroids at 1/4; depth_init (T, M);
    sched from edge_schedule. rng (ints) turns on the reference's two
    training-time regularizers, as static-shape masks: corr-gradient
    dropout (gradients reach the maps through a `corr_grad_keep` share of
    the edges each step, reference altcorr/correlation.py:16-30) and edge
    removal (when frame n is introduced, with probability `edge_dropout`
    every edge touching frame n - 4 is masked for good, reference
    net.py:239-244). gs_init (T, 7): the pose curriculum's first window.
    Returns one (sup, valid, co_pred, co_gt, Gs, n) per unroll step."""
    T, M = coords.shape[0], coords.shape[1]
    dev = coords.device
    intr4 = intrinsics / 4.0

    # both encoders on all frames in one batched call
    feats = net.patchify_frames(2.0 * (images / 255.0) - 0.5, coords)
    fmap1, fmap2 = feats['fmap1'], feats['fmap2']
    gmap = feats['gmap'].reshape(T * M, P, P, -1).contiguous()
    imap = feats['imap'].reshape(T * M, DIM)
    patch_xy = feats['patch_xy'].reshape(T * M, 2, P, P)

    # GT patch depth at the centroids
    depth_gt = torch.stack([
        extract_patches(disps_gt[t][..., None], coords[t], 0)[:, 0, 0, 0]
        for t in range(T)]).reshape(T * M)
    depth = depth_init.reshape(T * M)
    xy_center = patch_xy[:, :, P // 2, P // 2]

    Gs = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=torch.float32,
                      device=dev).expand(T, 7)
    if structure_only:
        Gs = poses_gt
    elif gs_init is not None:
        # pose curriculum: the first window starts at a perturbation of GT;
        # frames introduced later still start from the previous estimate
        Gs = gs_init

    H4, W4 = fmap1.shape[1], fmap1.shape[2]
    bounds = torch.tensor([-64.0, -64.0, W4 + 64.0, H4 + 64.0], device=dev)
    gen = None if rng is None else _generator(rng)

    def ints(a, dtype=torch.int64):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    net_prev = torch.zeros((0, DIM), dtype=net.dtype, device=dev)
    live = torch.ones((0,), dtype=torch.bool, device=dev)
    traj = []
    prev_E = 0
    for ii_np, jj_np, kk_np, new_frame, n in sched:
        E = len(ii_np)
        ii, jj, kk = ints(ii_np), ints(jj_np), ints(kk_np)
        kk_ids, pair_ids, ix, jx = map(ints, _group_ids(ii_np, jj_np, kk_np))

        Gs = Gs.detach()
        depth = depth.detach()

        if E != prev_E:
            # new edges are appended at the end of the table, so their
            # zero-init hidden states append at the end too
            net_prev = torch.cat([net_prev, net_prev.new_zeros(
                (E - prev_E, DIM))])
            live = torch.cat([live, live.new_ones(E - prev_E)])
        if new_frame is not None:
            f = new_frame
            if not structure_only:
                Gs = torch.cat([Gs[:f], Gs[f - 1:f], Gs[f + 1:]])
            # new patches start at the median depth of the previous two
            # frames (even count: the mean of the middle two, as jnp.median)
            med = _median(depth[(f - 2) * M:f * M])
            depth = torch.cat([depth[:f * M], med.expand(M),
                               depth[(f + 1) * M:]])
            if gen is not None and edge_dropout > 0:
                hit = (ii == f - 4) | (jj == f - 4)
                drop = bool(torch.rand((), generator=gen) < edge_dropout)
                if drop:
                    live = live & ~hit

        # no gradient reaches the correlation through the coords (the
        # reference kernel's backward returns none for them): pose and
        # depth gradients come only through the BA and the loss
        coords_full = _transform_full(Gs, patch_xy, depth, intr4, ii, jj, kk)
        corr = corr_two_level_train(
            gmap, fmap1, fmap2, coords_full.detach().contiguous(),
            ints(kk_np, torch.int32), ints(jj_np, torch.int32))
        corr_feat = corr.reshape(E, -1)
        if gen is not None and corr_grad_keep < 1.0:
            # forward unchanged, gradients to the maps through the kept
            # edges only
            keep = (torch.rand(E, generator=gen) < corr_grad_keep).to(dev)
            sg = corr_feat.detach()
            corr_feat = sg + keep[:, None] * (corr_feat - sg)

        net_prev, delta, weight = net.update_op(
            net_prev, imap[kk], corr_feat, ix, jx, kk_ids, pair_ids,
            num_segments=E, edge_mask=live)
        weight = weight * live[:, None]

        target = coords_full[:, P // 2, P // 2, :] + delta
        for _ in range(2):
            Gs, depth = bundle_adjust_train(
                Gs, xy_center, depth, intr4, target, weight, ii, jj, kk,
                bounds, W=T - 1, PC=T * M, fixedp=1,
                structure_only=structure_only)

        # supervision on short-range edges (reference net.py:264-268);
        # dropped edges leave the loss as if removed
        dij = (ii - jj).abs()
        sup = (dij > 0) & (dij <= 2) & live
        co_pred = _transform_full(Gs, patch_xy, depth, intr4, ii, jj, kk)
        co_gt, valid = _transform_full(poses_gt, patch_xy, depth_gt, intr4,
                                       ii, jj, kk, with_valid=True)
        traj.append((sup, valid, co_pred, co_gt, Gs, n))
        prev_E = E

    return traj


# ---------------------------------------------------------------------------
# loss (reference train.py:85-120)
# ---------------------------------------------------------------------------

def kabsch_umeyama_scale(A, B):
    """Optimal scale aligning B to A (reference train.py:31-41)."""
    EA = A.mean(dim=0)
    EB = B.mean(dim=0)
    VarA = ((A - EA) ** 2).sum(-1).mean()
    H = (A - EA).T @ (B - EB) / A.shape[0]
    return VarA / torch.linalg.svdvals(H).sum()


def _safe_norm(x, dim=-1):
    """L2 norm whose gradient is 0 (not NaN) at ||x|| = 0: the schedule's
    ii == jj self-edges have an exactly zero residual."""
    d2 = (x * x).sum(dim)
    pos = d2 > 0
    return torch.sqrt(torch.where(pos, d2, 1.0)) * pos.to(x.dtype)


def trajectory_loss(traj, poses_gt, flow_weight=0.1, pose_weight=10.0,
                    structure_only=False):
    """dpvo_tpu trajectory_loss: (total, aux) with aux {'tr', 'ro'} (the
    last step's mean translation / rotation errors) unless
    structure_only."""
    total = 0.0
    aux = {}
    for i, (sup, valid, co_pred, co_gt, Gs, n) in enumerate(traj):
        E = co_pred.shape[0]
        e = _safe_norm(co_pred - co_gt).reshape(E, -1)         # (E, P * P)
        # min over patch pixels of valid supervised edges
        e_min = torch.where(valid.reshape(E, -1) > 0.5, e,
                            float('inf')).amin(-1)
        fin = torch.isfinite(e_min)
        w_sup = sup.float() * fin.float()
        e_min = torch.where(fin, e_min, 0.0)
        flow_loss = (e_min * w_sup).sum() / w_sup.sum().clamp(min=1.0)
        total = total + flow_weight * flow_loss

        if not structure_only and i >= 2:
            N = Gs.shape[0]
            P1 = lie.se3_inv(Gs)
            P2 = lie.se3_inv(poses_gt)
            with torch.no_grad():
                s = kabsch_umeyama_scale(P2[:, :3], P1[:, :3]).clamp(max=10.0)
            P1 = lie.se3_scale(P1, s)
            # off-diagonal pairs: the diagonal's dP dG^-1 is exactly the
            # identity, where se3_log's partials risk 0 x NaN
            iig, jjg = np.meshgrid(np.arange(N), np.arange(N), indexing='ij')
            od = iig.ravel() != jjg.ravel()
            iig = torch.from_numpy(iig.ravel()[od]).to(Gs.device)
            jjg = torch.from_numpy(jjg.ravel()[od]).to(Gs.device)
            dP = lie.se3_mul(lie.se3_inv(P1[iig]), P1[jjg])
            dG = lie.se3_mul(lie.se3_inv(P2[iig]), P2[jjg])
            e1 = lie.se3_log(lie.se3_mul(dP, lie.se3_inv(dG)))
            tr = _safe_norm(e1[..., 0:3])
            ro = _safe_norm(e1[..., 3:6])
            npairs = float(tr.shape[0])
            total = total + pose_weight * (tr.sum() + ro.sum()) / npairs
            aux['tr'] = tr.detach().sum() / npairs
            aux['ro'] = ro.detach().sum() / npairs
    return total, aux


# ---------------------------------------------------------------------------
# weights, optimizer and train step
# ---------------------------------------------------------------------------

def onecycle_lr(step, total_steps, peak_value, pct_start=0.01,
                pct_final=0.99, div_factor=25.0, final_div_factor=1e4):
    """optax.linear_onecycle_schedule's rate at `step`: linear from
    peak / div to peak at int(pct_start * total), back to peak / div at
    int(pct_final * total), to that / final_div at total, then constant.
    (Not torch's OneCycleLR, whose three phases are shaped otherwise.)"""
    bounds = [0, int(pct_start * total_steps), int(pct_final * total_steps),
              total_steps]
    if min(np.diff(bounds)) <= 0:
        raise ValueError(f'total_steps={total_steps} collapses the '
                         f'one-cycle phases (optax gives NaN rates there)')
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / div_factor, 1.0 / final_div_factor])
    for a, b, va, vb in zip(bounds[:-1], bounds[1:], values[:-1],
                            values[1:]):
        if a <= step < b:
            return float((vb - va) * ((step - a) / (b - a)) + va)
    return float(values[-1])


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), adamw(linear one-cycle,
    weight_decay=1e-6)) over torch parameters. step() clips every
    parameter's .grad by the global norm exactly as optax does (g / norm *
    clip where norm >= clip; torch's clip_grad_norm_ adds 1e-6 to the
    norm), takes one AdamW step at the schedule's rate and advances it."""

    def __init__(self, params, lr, total_steps, clip):
        self.params = list(params)
        self.clip = clip
        self.adamw = torch.optim.AdamW(self.params, lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=1e-6)
        self.schedule = torch.optim.lr_scheduler.LambdaLR(
            self.adamw, lambda t: onecycle_lr(t, total_steps, lr) / lr)

    @torch.no_grad()
    def step(self):
        for p in self.params:      # optax updates (and decays) every leaf
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        clipped = norm >= self.clip
        for g in grads:
            g.copy_(torch.where(clipped, g / norm * self.clip, g))
        self.adamw.step()
        self.schedule.step()
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(params, lr=8e-5, total_steps=240000, clip=10.0):
    """AdamW + linear one-cycle after a global-norm clip (reference
    train.py:64-67; dpvo_tpu make_optimizer)."""
    return Optimizer(params, lr, total_steps, clip)


class _SequenceLoss(nn.Module):
    """One sequence's unroll and loss as a module call, so that
    torch.func.functional_call can run it on bf16 copies of the
    parameters."""

    def __init__(self, net, sched, structure_only):
        super().__init__()
        self.net = net
        self.sched = sched
        self.structure_only = structure_only

    def forward(self, images, poses_gt, disps, intrinsics, coords,
                depth_init, rng=None, gs_init=None):
        traj = vonet_forward(self.net, images, poses_gt, disps, intrinsics,
                             coords, depth_init, self.sched,
                             structure_only=self.structure_only, rng=rng,
                             gs_init=gs_init)
        return trajectory_loss(traj, poses_gt,
                               structure_only=self.structure_only)


SEQ_KEYS = ('images', 'poses_gt', 'disps', 'intrinsics', 'coords',
            'depth_init')


def make_train_step(net, optimizer, sched, structure_only=False,
                    mixed_precision=True, group=None):
    """step(batch) -> (mean loss, aux): one optimizer step of `net` (f32
    master parameters) on a batch dict with leading batch axis B
    (dpvo_tpu's contract: images (B, T, H, W, 3), poses_gt (B, T, 7),
    disps (B, T, H/4, W/4), intrinsics (B, 4), coords (B, T, M, 2),
    depth_init (B, T, M); optional rng (B, k) ints, gs_init (B, T, 7)),
    numpy arrays or tensors. Under mixed precision each sequence runs on a
    bf16 copy of the parameters made inside the step, so the gradients
    land on the f32 masters.

    With a torch.distributed group of W ranks the batch is this rank's
    share (parallel/mesh.py:shard_batch) of a global batch of W x B: each
    sequence's loss is scaled by 1 / (W x B), the gradients are summed
    over the ranks before the optimizer's clip (so clip and AdamW see the
    global batch's gradient on every rank), and the mean loss and aux are
    the global batch's, gathered in rank order."""
    unroll = _SequenceLoss(net, sched, structure_only)
    world = 1 if group is None else torch.distributed.get_world_size(group)

    def step(batch):
        dev = next(net.parameters()).device
        b = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v).to(dev)
             for k, v in batch.items() if k != 'rng'}
        B = b['images'].shape[0]
        losses, auxes = [], []
        for i in range(B):
            args = tuple(b[k][i].float() for k in SEQ_KEYS)
            kw = dict(rng=None if batch.get('rng') is None else
                      np.asarray(batch['rng'])[i],
                      gs_init=b['gs_init'][i] if 'gs_init' in b else None)
            if mixed_precision:
                params = {'net.' + k: v.to(torch.bfloat16)
                          for k, v in net.named_parameters()}
                loss, aux = torch.func.functional_call(unroll, params, args,
                                                       kw)
            else:
                loss, aux = unroll(*args, **kw)
            (loss / (world * B)).backward()
            losses.append(loss.detach())
            auxes.append(aux)
        if group is not None:
            all_reduce_grads(net.parameters(), group)
        optimizer.step()
        loss = torch.stack(losses)
        aux = {k: torch.stack([a[k] for a in auxes]) for k in auxes[0]}
        if group is not None:
            loss = all_gather_cat(loss, group)
            aux = {k: all_gather_cat(v, group) for k, v in aux.items()}
        return loss.mean(), aux

    return step
