"""Device-resident VO state machine (the pure-VO main path).

Port of dpvo_tpu/runtime/device_vo.py:vo_frame / vo_refine (reference
dpvo/dpvo.py:377-473). All per-frame tensors stay on the device: the
pair-blocked edge table (GP_CAP pairs x M patches, with validity masks),
patch and feature buffers, the feature-ring slot map, poses, depths and the
trajectory deltas of removed keyframes.

Control flow. As in dpvo_tpu, the scalars that decide it -- the keyframe
count `n`, the input counter `counter` and `is_init` -- are 0-d tensors on
the state's device, and every decision that depends on a device value is
made there: the motion model's branches and the depth init are
torch.where, the rows written at `n`, the slot allocator's window, the
pair append (cnt + cumsum(new_v) - 1, rows past GP dropped) and the BA
windows are device indices, and the keyframe test `mflow < kf_thresh` is a
device bool `rm` that gates the trajectory delta, the pair drop and a
masked shift of whole frames over the KEYFRAME_INDEX rows that can move.
From the bootstrap frame on, the host reads nothing per frame.

One thing eager PyTorch cannot leave on the device: how many update
iterations a frame runs (12 at bootstrap, 1 once initialized, 0 before;
dpvo_tpu's fori_loop takes a device trip count). Before initialization no
keyframe is removed, so `n` is the number of accepted frames and the host
follows it exactly in `VOState.host_n` until the bootstrap frame. With
force_accept that takes no read; without it the host reads one value per
pre-init frame after the first, the motion probe's accept decision, where
dpvo_tpu's lax.cond reads nothing. That read is the only one left.

Ingest (vo_frame_packed1): one flat uint8 upload row per frame, [image
bytes (rgb, or I420 planes turned back into RGB here by i420_to_rgb) |
(M, 4) f32 aux bytes]. An optional target oracle (the
accuracy tests' seam, _call_oracle) replaces the correlation and the update
operator; the reprojection and the BA still run.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import lie
from ..ba_pairs import bundle_adjust_pairs, pair_centers, pair_depth, \
    window_rows
from ..models.vonet import DIM, P
from ..ops.corr_fused import corr_fused
from ..ops.corr_onepass import corr_two_level
from ..tracing import span

CNT_CAP = 16384     # max input frames per sequence


@dataclass
class VOState:
    poses: torch.Tensor        # (N, 7)
    centers: torch.Tensor      # (N, 2*M) frame-major (M, 2) blocks
    depth: torch.Tensor        # (N*M,)
    colors: torch.Tensor       # (N, M, 3) f32
    imap: torch.Tensor         # (pmem*M, DIM)
    gmap: torch.Tensor         # (pmem*M, P, P, 128)
    fmap1: torch.Tensor        # (mem, H/4, W/4, 128) channels-last
    fmap2: torch.Tensor        # (mem, H/16, W/16, 128) channels-last
    pi: torch.Tensor           # (GP,) int64 source frame per pair
    pj: torch.Tensor           # (GP,) int64 target frame per pair
    pvalid: torch.Tensor       # (GP,) bool
    net: torch.Tensor          # (GP, M, DIM)
    target: torch.Tensor       # (GP, M, 2)
    weight: torch.Tensor       # (GP, M, 2)
    tstamps: torch.Tensor      # (N,) int64: keyframe -> input counter
    in_times: torch.Tensor     # (CNT_CAP,) f32 raw input timestamps
    delta_src: torch.Tensor    # (CNT_CAP,) int64 (-1 = live keyframe)
    delta_pose: torch.Tensor   # (CNT_CAP, 7)
    intr: torch.Tensor         # (4,) intrinsics / RES
    fslot: torch.Tensor        # (N,) int64 frame index -> feature ring slot
    n: torch.Tensor            # () int64 keyframe count
    counter: torch.Tensor      # () int64 input frame count
    is_init: torch.Tensor      # () bool
    # n on the host until the bootstrap frame, exact there (no keyframe is
    # removed before it); None from the bootstrap frame on
    host_n: int | None = 0

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}


def ring_capacity(cfg):
    """Feature-ring slots: the slot allocator scans a live window of
    REMOVAL_WINDOW + 6 frames, so the ring must strictly exceed it."""
    return max(36, int(cfg.REMOVAL_WINDOW) + 7)


def _gp_cap(cfg):
    """Static pair capacity = exact steady-state maximum of live pairs.

    A source frame i = n-k contributes at most r backward pairs plus
    min(r-1, k-1) forward pairs; sources retire when k > REMOVAL_WINDOW.
    One frame's fresh appends (2r-1) are added as margin."""
    r = cfg.PATCH_LIFETIME
    rw = cfg.REMOVAL_WINDOW
    total = sum(min(r - 1, k - 1) + r for k in range(1, rw + 1))
    total += 2 * r - 1
    return int(-(-total // 64) * 64)


def init_state(cfg, ht, wd, intrinsics, device, dtype):
    """Empty VOState on `device`; feature buffers in `dtype`."""
    M = cfg.PATCHES_PER_FRAME
    N = cfg.BUFFER_SIZE
    pmem = ring_capacity(cfg)
    GP = _gp_cap(cfg)
    h4, w4 = ht // 4, wd // 4
    kw = dict(device=device)
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], **kw)
    return VOState(
        poses=ident.repeat(N, 1),
        centers=torch.zeros((N, 2 * M), **kw),
        depth=torch.ones((N * M,), **kw),
        colors=torch.zeros((N, M, 3), **kw),
        imap=torch.zeros((pmem * M, DIM), dtype=dtype, **kw),
        gmap=torch.zeros((pmem * M, P, P, 128), dtype=dtype, **kw),
        fmap1=torch.zeros((pmem, h4, w4, 128), dtype=dtype, **kw),
        fmap2=torch.zeros((pmem, h4 // 4, w4 // 4, 128), dtype=dtype, **kw),
        pi=torch.zeros((GP,), dtype=torch.long, **kw),
        pj=torch.zeros((GP,), dtype=torch.long, **kw),
        pvalid=torch.zeros((GP,), dtype=torch.bool, **kw),
        net=torch.zeros((GP, M, DIM), dtype=dtype, **kw),
        target=torch.zeros((GP, M, 2), **kw),
        weight=torch.zeros((GP, M, 2), **kw),
        tstamps=torch.zeros((N,), dtype=torch.long, **kw),
        in_times=torch.zeros((CNT_CAP,), **kw),
        delta_src=torch.full((CNT_CAP,), -1, dtype=torch.long, **kw),
        delta_pose=ident.repeat(CNT_CAP, 1),
        intr=torch.as_tensor(np.asarray(intrinsics, np.float32) / 4.0,
                             device=device),
        fslot=torch.zeros((N,), dtype=torch.long, **kw),
        n=torch.zeros((), dtype=torch.long, **kw),
        counter=torch.zeros((), dtype=torch.long, **kw),
        is_init=torch.zeros((), dtype=torch.bool, **kw),
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _median(x):
    """Median that averages the two middle values of an even count, like
    jnp.median (torch.median returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    k = s.shape[0]
    return s[k // 2] if k % 2 else 0.5 * (s[k // 2 - 1] + s[k // 2])


def _row(buf, i):
    """buf[i] for a 0-d integer tensor i, clamped into the buffer like a
    JAX gather: an index_select, so no read."""
    return buf.index_select(0, i.clamp(0, buf.shape[0] - 1).reshape(1))[0]


def _rows(buf, start, size):
    """buf[start:start + size] for a 0-d integer tensor start, the window
    clamped into the buffer (lax.dynamic_slice)."""
    return buf.index_select(0, window_rows(start, size, buf.shape[0],
                                           buf.device))


def _center_flow(poses, centers, depth, intr, i, j, M, beta=0.5):
    """Mean blended flow magnitude of frame i's patch centers into frame j
    (reference pops.flow_mag at the keyframe test, dpvo.py:257-264); i, j
    0-d integer tensors."""
    fx, fy, cx, cy = intr.unbind(0)
    c = _row(centers, i).reshape(M, 2)
    d = _rows(depth, i * M, M)
    X0 = torch.stack([(c[:, 0] - cx) / fx, (c[:, 1] - cy) / fy,
                      torch.ones_like(d), d], dim=-1)
    Gij = lie.se3_mul(_row(poses, j), lie.se3_inv(_row(poses, i)))

    def proj(X):
        Z = X[..., 2].clamp(min=0.1)
        return torch.stack([fx * X[..., 0] / Z + cx,
                            fy * X[..., 1] / Z + cy], dim=-1)

    co1 = proj(lie.se3_act4(Gij[None], X0))
    Xt = torch.cat([X0[..., :3] + d[:, None] * Gij[:3][None], X0[..., 3:]],
                   dim=-1)
    co2 = proj(Xt)
    f1 = torch.linalg.vector_norm(co1 - c, dim=-1)
    f2 = torch.linalg.vector_norm(co2 - c, dim=-1)
    return (beta * f1 + (1 - beta) * f2).mean()


def _slot_of(fslot, idx):
    """Ring slot of each frame index."""
    return fslot[idx.clamp(min=0)]


def _pair_neighbors(pi, pj, pvalid):
    """Per-pair previous / next pair with the same source frame, ordered by
    target frame (replaces fastba.neighbors, ba.cpp:59-97). -1 if none."""
    same_i = (pi[:, None] == pi[None, :]) & pvalid[:, None] & pvalid[None, :]
    dj = pj[None, :] - pj[:, None]
    big = 10 ** 6
    prev_key = torch.where(same_i & (dj < 0), pj[None, :], -big)
    next_key = torch.where(same_i & (dj > 0), -pj[None, :], -big)
    pmax, prev = prev_key.max(dim=1)
    nmax, nxt = next_key.max(dim=1)
    return (torch.where(pmax > -big, prev, -1),
            torch.where(nmax > -big, nxt, -1))


def _reproject_pairs(poses, centers, depth, intr, pi, pj, M):
    """(GP, M, P, P, 2) full-patch reprojection from the patch centers."""
    fx, fy, cx, cy = intr.unbind(0)
    c = pair_centers(centers, pi, M)                       # (GP, M, 2)
    d = pair_depth(depth, pi, M)                           # (GP, M)
    off = torch.arange(-(P // 2), P // 2 + 1, dtype=torch.float32,
                       device=poses.device)
    shape = c.shape[:2] + (P, P)
    gx = (c[..., 0, None, None] + off[None, None, None, :]).expand(shape)
    gy = (c[..., 1, None, None] + off[None, None, :, None]).expand(shape)
    xn = (gx - cx) / fx
    yn = (gy - cy) / fy
    X0 = torch.stack([xn, yn, torch.ones_like(xn),
                      d[..., None, None].expand(shape)], dim=-1)
    Gij = lie.se3_mul(poses[pj.clamp(min=0)],
                      lie.se3_inv(poses[pi.clamp(min=0)]))
    X1 = lie.se3_act4(Gij[:, None, None, None, :], X0)
    Z = X1[..., 2].clamp(min=0.1)
    return torch.stack([fx * X1[..., 0] / Z + cx,
                        fy * X1[..., 1] / Z + cy], dim=-1)


def _shift_frames(st, k, n, rm, M, span):
    """Keyframe removal as a masked shift of whole frames: where the 0-d
    bool `rm` holds, frame rows [k, n - 1) take rows [k + 1, n) (k, n 0-d
    integer tensors, n - k <= span): poses, tstamps, colors, centers, fslot
    and depth in blocks of M. Only the span rows from k can move: they are
    gathered by device index and written back, the rest of the buffers is
    not touched. The feature buffers stay put; the fslot map that points
    into them shifts instead."""
    N = st.poses.shape[0]
    rows = window_rows(k, min(span, N), N, st.poses.device)
    src = torch.where(rm & (rows >= k) & (rows < n - 1), rows + 1, rows)
    for buf in (st.poses, st.tstamps, st.colors, st.centers, st.fslot,
                st.depth.view(N, M)):
        buf.index_copy_(0, rows, buf.index_select(0, src))


def _compact_pairs(st):
    """Sort pairs by target frame, invalid last (stable); permute the
    per-pair state. Valid pairs become a prefix, and edges sharing a target
    frame are adjacent (the correlation kernel's cache locality)."""
    BIG = 1 << 20
    order = torch.sort(torch.where(st.pvalid, st.pj, BIG), stable=True).indices
    for name in ('pi', 'pj', 'pvalid', 'net', 'target', 'weight'):
        setattr(st, name, getattr(st, name)[order])


def _set_rows(buf, idx, val):
    """buf[idx] = val (a tensor on buf's device) where idx == len(buf)
    means "drop" (the .at[].set(mode='drop') semantics): the write goes to
    a spare row."""
    return torch.cat([buf, buf[:1]]).index_copy_(0, idx, val)[:-1]


def _corr_features(st, pi_a, pj_a, pv_a, poses, depth, M, corr_dtype,
                   corr_impl='onepass'):
    """Reprojected coords, correlation features and context for pairs
    (pi_a, pj_a): (G, M, P, P, 2), (G*M, 882), (G*M, DIM). corr_impl
    'onepass' runs K1 (edges of invalid pairs are zeros), 'fused' K2 + K3
    over every edge, as dpvo_tpu does (device_vo.py:458-463)."""
    coords_r = _reproject_pairs(poses, st.centers, depth, st.intr, pi_a, pj_a,
                                M)
    G = pi_a.shape[0]
    E = G * M
    pmem = st.gmap.shape[0] // M
    psl = _slot_of(st.fslot, pi_a)
    ar = torch.arange(M, device=psl.device)
    kk = (psl[:, None] * M + ar[None, :]).reshape(E).int()
    jj = _slot_of(st.fslot, pj_a).repeat_interleave(M).int()
    coords_f = coords_r.reshape(E, P, P, 2)
    if corr_impl == 'onepass':
        nv = pv_a.sum() * M       # valid pairs are a prefix (_compact_pairs)
        corr = corr_two_level(st.gmap, st.fmap1, st.fmap2, coords_f, kk, jj,
                              nv=nv, out_dtype=corr_dtype)
    else:
        corr = torch.stack(corr_fused(st.gmap, st.fmap1, st.fmap2, coords_f,
                                      kk, jj), dim=-1)
    inp = st.imap.view(pmem, M * DIM)[psl].reshape(E, DIM)
    return coords_r, corr.reshape(E, -1), inp


def _call_oracle(oracle, st, M):
    """Targets and weights of every pair edge from a target oracle with the
    hybrid runtime's contract, (poses, patch_xy, depth, intr, ii, jj, kk)
    -> ((E, 2), (E, 2)) (runtime/state.py:update_step). The pair-blocked
    state keeps bare centers, so the edge view is synthesized: patch_xy
    repeats each center over the P x P grid (an oracle reads only the
    center tap), and ii / jj go through st.tstamps to input-frame indices,
    which is what a ground-truth oracle indexes its trajectory by; they
    equal the keyframe indices until a keyframe is removed."""
    GP = st.pi.shape[0]
    ar = torch.arange(M, device=st.pi.device)
    ii = st.tstamps[st.pi].repeat_interleave(M)
    jj = st.tstamps[st.pj].repeat_interleave(M)
    kk = (st.pi[:, None] * M + ar).reshape(GP * M)
    cent = st.centers.reshape(-1, 2)
    patch_xy = cent[:, :, None, None].expand(cent.shape + (P, P))
    intr = st.intr[None].expand(st.poses.shape[0], 4)
    return oracle(st.poses, patch_xy, st.depth, intr, ii, jj, kk)


def _update_ba(network, st, n1, *, M, W, PCF, iterations,
               corr_impl='onepass', oracle=None):
    """`iterations` rounds of correlation + update operator + 2-step BA over
    the live pairs (the body of vo_frame's update loop and of vo_refine).
    W = OPTIMIZATION_WINDOW: the BA's pose slots, ending at keyframe n1 (a
    0-d integer tensor). With an oracle, its targets and weights replace
    the correlation and the update operator; the net state stays as it
    is. Spans: vo.edges, then per iteration vo.iter holding vo.corr,
    vo.update (the update operator and the target and weight writes; with
    an oracle, its reprojection and call) and vo.ba."""
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    with span('vo.edges'):
        ar = torch.arange(M, device=st.pi.device)
        edge_mask = st.pvalid.repeat_interleave(M)
        mask3 = edge_mask.reshape(GP, M, 1)
        t0 = (n1 - W).clamp(min=1)
        fbase = (n1 - (PCF - 2)).clamp(min=0)
        if oracle is None:
            ix_pair, jx_pair = _pair_neighbors(st.pi, st.pj, st.pvalid)
            ix_e = torch.where(ix_pair[:, None] >= 0,
                               ix_pair[:, None] * M + ar, -1).reshape(GP * M)
            jx_e = torch.where(jx_pair[:, None] >= 0,
                               jx_pair[:, None] * M + ar, -1).reshape(GP * M)
            # patch groups keyed by source ring slot (unique among live
            # frames)
            kk_ids = (_slot_of(st.fslot, st.pi)[:, None] * M
                      + ar).reshape(GP * M)
            pair_ids = torch.arange(GP, device=ar.device).repeat_interleave(M)
    for _ in range(iterations):
        with span('vo.iter'):
            if oracle is None:
                with span('vo.corr'):
                    coords_r, corr_feat, inp = _corr_features(
                        st, st.pi, st.pj, st.pvalid, st.poses, st.depth, M,
                        network.dtype, corr_impl)
                with span('vo.update'):
                    netf, delta, wgt = network.update_op(
                        st.net.reshape(GP * M, DIM), inp, corr_feat, ix_e,
                        jx_e, kk_ids, pair_ids, num_segments=GP * M,
                        edge_mask=edge_mask, num_segments_kk=pmem * M,
                        num_segments_ij=GP,
                        gather_pairs=(ix_pair, jx_pair, M))
                    st.net = netf.reshape(GP, M, DIM)
                    center = coords_r[:, :, P // 2, P // 2, :]
                    st.target = center + delta.reshape(GP, M, 2)
                    st.weight = torch.where(mask3, wgt.reshape(GP, M, 2), 0.0)
            else:
                with span('vo.update'):
                    center = _reproject_pairs(
                        st.poses, st.centers, st.depth, st.intr, st.pi, st.pj,
                        M)[:, :, P // 2, P // 2]
                    tgt, wgt = _call_oracle(oracle, st, M)
                    st.target = torch.where(mask3, tgt.reshape(GP, M, 2),
                                            center)
                    st.weight = torch.where(mask3, wgt.reshape(GP, M, 2), 0.0)
            with span('vo.ba'):
                st.poses, st.depth = bundle_adjust_pairs(
                    st.poses, st.centers, st.depth, st.intr, st.target,
                    st.weight, 1e-4, st.pi, st.pj, st.pvalid, t0, n1, fbase,
                    M=M, W=W, PCF=PCF, iterations=2)


# ---------------------------------------------------------------------------
# the per-frame step
# ---------------------------------------------------------------------------

@torch.no_grad()
def vo_frame(network, st, image, aux, *, M, W, PCF, r, kf_index,
             removal_window, kf_thresh, motion_damping, motion_model,
             force_accept=False, corr_impl='onepass', oracle=None):
    """Track one frame (reference dpvo.py:377-473); updates `st` in place.

    image (H, W, 3) on the state's device, uint8 or f32 in [0, 255]
    (i420_to_rgb's output); aux (M, 4) f32 [x, y, depth seed, tstamp]
    (patch centroids at 1/4 scale, the frame's depth seeds, its timestamp
    in every row). oracle: see _update_ba; pair it with force_accept (the
    motion probe still runs the learned network). Reads nothing back but
    the probe's accept decision before initialization (module docstring).

    Spans (dpvo_torch.tracing), one after another: vo.patchify, vo.store
    (motion model, depth init, row writes, ring slot, feature stores),
    vo.probe (pre-init frames without force_accept), vo.pairs (counter,
    init flags, pair append, fresh rows, compaction), _update_ba's
    vo.edges and vo.iter, and once initialized vo.keyframe holding
    vo.shift. Every device op the frame launches lies in one of them."""
    n, counter = st.n, st.counter
    N = st.poses.shape[0]
    GP = st.pi.shape[0]
    pmem = st.gmap.shape[0] // M
    dev = st.poses.device
    coords, depth_seed, tstamp = aux[:, :2], aux[:, 2], aux[0, 3]

    # ---------------- patchify + store ---------------- #
    ndt = network.dtype
    with span('vo.patchify'):
        img = image.to(ndt) * torch.full((), 2.0 / 255.0, dtype=ndt,
                                         device=dev) \
            - torch.full((), 0.5, dtype=ndt, device=dev)
        feats = network.patchify_frame(img, coords)

    with span('vo.store'):
        # motion model (dpvo.py:410-424); indices clamp like the JAX
        # gathers
        P1 = _row(st.poses, n - 1)
        pose_init = P1
        if motion_model == 'DAMPED_LINEAR':
            P2 = _row(st.poses, n - 2)
            tc = _row(st.in_times, counter - 1)
            tb = _row(st.in_times, counter - 2)
            fac = torch.where((counter >= 2) & ((tb - tc).abs() > 0),
                              (tstamp - tc) / torch.clamp(tc - tb, min=1e-6),
                              1.0)
            xi = motion_damping * fac * lie.se3_log(
                lie.se3_mul(P1, lie.se3_inv(P2)))
            pose_init = torch.where(n > 1, lie.se3_mul(lie.se3_exp(xi), P1),
                                    P1)

        # depth init (dpvo.py:426-431): median of the last 3 frames' depths
        med = _median(_rows(st.depth, (n - 3).clamp(min=0) * M, 3 * M))
        depth_init = torch.where(st.is_init, med.expand(M), depth_seed)

        nw = n.clamp(max=N - 1).reshape(1)  # dynamic_update_slice clamps
        st.poses.index_copy_(0, nw, pose_init[None])
        st.centers.index_copy_(
            0, nw, feats['patch_xy'][:, :, 1, 1].reshape(1, 2 * M))
        st.depth.index_copy_(0, window_rows(n * M, M, N * M, dev),
                             depth_init)
        st.colors.index_copy_(0, nw, feats['clr'][None])
        st.tstamps.index_copy_(0, nw, counter.reshape(1))
        st.in_times.index_copy_(0, counter.clamp(max=CNT_CAP - 1).reshape(1),
                                tstamp.reshape(1))

        # ring-slot allocation: the first slot no live frame references,
        # over the fixed window of PCF + 2 frames ending at n
        live_cap = PCF + 2
        live_lo = (n - live_cap + 1).clamp(min=0)
        pos = window_rows(live_lo, min(live_cap, N), N, dev)
        used = torch.zeros((pmem + 1,), dtype=torch.int32, device=dev)
        used.index_fill_(0, torch.where((pos >= live_lo) & (pos < n),
                                        st.fslot.index_select(0, pos), pmem),
                         1)
        slot = torch.argmin(used[:pmem]).reshape(1)  # first minimum: lowest
        st.fslot.index_copy_(0, nw, slot)
        st.imap.view(pmem, M, DIM).index_copy_(0, slot,
                                               feats['imap'][None].to(ndt))
        st.gmap.view(pmem, M, P, P, 128).index_copy_(
            0, slot, feats['gmap'][None].to(ndt))
        st.fmap1.index_copy_(0, slot, feats['fmap1'][None].to(ndt))
        st.fmap2.index_copy_(0, slot, feats['fmap2'][None].to(ndt))

    # ---------------- probe (pre-init accept test) ---------------- #
    if force_accept or st.host_n is None or st.host_n == 0:
        accept = True
    else:
        with span('vo.probe'):
            pi_p = (n - 1).clamp(min=0).reshape(1)
            _, corr_feat, inp = _corr_features(
                st, pi_p, pi_p + 1, torch.ones((1,), dtype=torch.bool,
                                               device=dev),
                st.poses, st.depth, M, ndt, corr_impl)
            ids = torch.arange(M, device=dev)
            neg = torch.full((M,), -1, dtype=torch.long, device=dev)
            _, delta, _ = network.update_op(
                torch.zeros((M, DIM), dtype=ndt, device=dev), inp, corr_feat,
                neg, neg, ids, torch.zeros((M,), dtype=torch.long,
                                           device=dev),
                num_segments=M, edge_mask=torch.ones((M,), dtype=torch.bool,
                                                     device=dev))
            # the one read left: the accept decision (pre-init frames only)
            accept = bool(_median(torch.linalg.vector_norm(delta, dim=-1))
                          >= 2.0)

    with span('vo.pairs'):
        st.counter = counter + 1
        if not accept:
            # rejected pre-init frame: identity delta to the previous input
            st.delta_src.index_copy_(0, counter.reshape(1),
                                     (counter - 1).reshape(1))
            return st

        n1 = n + 1
        was_init = st.host_n is None
        bootstrap = not was_init and st.host_n + 1 == 8
        st.host_n = None if was_init or bootstrap else st.host_n + 1
        st.is_init = st.is_init | (n1 == 8)

        # ---- append pair factors (dpvo.py:457-459) ---- #
        # forward (i, n1-1) for i in [n1-r, n1-1); backward (n1-1, j) for j
        # in [n1-r, n1); pairs with a negative frame, and rows past GP,
        # dropped
        ar = torch.arange(r, device=dev)
        last = (n1 - 1).expand(r)
        new_i = torch.cat([n1 - r + ar[:-1], last])
        new_j = torch.cat([last[:-1], n1 - r + ar])
        new_v = (new_i >= 0) & (new_j >= 0)
        idx = st.pvalid.sum() + torch.cumsum(new_v.long(), 0) - 1
        idx = torch.where(new_v & (idx < GP), idx, GP)
        st.pi = _set_rows(st.pi, idx, new_i.clamp(min=0))
        st.pj = _set_rows(st.pj, idx, new_j.clamp(min=0))
        # the rows written are the valid new pairs': new_v is True there
        st.pvalid = _set_rows(st.pvalid, idx, new_v)
        fresh = _set_rows(torch.zeros(GP, dtype=torch.bool, device=dev), idx,
                          new_v)
        st.net = st.net.masked_fill(fresh[:, None, None], 0.0)
        st.target = st.target.masked_fill(fresh[:, None, None], 0.0)
        st.weight = st.weight.masked_fill(fresh[:, None, None], 0.0)
        _compact_pairs(st)

    # ---- update iterations (12 at bootstrap, 1 once initialized) ---- #
    iters = 12 if bootstrap else (1 if was_init else 0)
    _update_ba(network, st, n1, M=M, W=W, PCF=PCF, iterations=iters,
               corr_impl=corr_impl, oracle=oracle)
    st.n = n1

    # ---- keyframe decision (dpvo.py:266-310), on the device ---- #
    if was_init:
        with span('vo.keyframe'):
            i = n1 - kf_index - 1
            j = n1 - kf_index + 1
            mflow = 0.5 * (
                _center_flow(st.poses, st.centers, st.depth, st.intr, i, j,
                             M) +
                _center_flow(st.poses, st.centers, st.depth, st.intr, j, i,
                             M))
            rm = mflow < kf_thresh
            k = n1 - kf_index
            t1 = st.tstamps.index_select(0, k.reshape(1))
            dP = lie.se3_mul(_row(st.poses, k),
                             lie.se3_inv(_row(st.poses, k - 1)))
            st.delta_src.index_copy_(0, t1, torch.where(
                rm, _row(st.tstamps, k - 1),
                st.delta_src.index_select(0, t1)))
            st.delta_pose.index_copy_(0, t1, torch.where(
                rm, dP[None], st.delta_pose.index_select(0, t1)))

            drop = rm & ((st.pi == k) | (st.pj == k))
            st.pvalid = st.pvalid & ~drop
            st.pi = torch.where(rm & (st.pi > k), st.pi - 1, st.pi)
            st.pj = torch.where(rm & (st.pj > k), st.pj - 1, st.pj)
            with span('vo.shift'):
                _shift_frames(st, k, n1, rm, M, kf_index)
            st.n = n1 - rm.long()

            # retire pairs outside the window (dpvo.py:305-310)
            st.pvalid = st.pvalid & (st.pi >= st.n - removal_window)
            _compact_pairs(st)
    return st


@torch.no_grad()
def vo_refine(network, st, *, M, W, PCF, corr_impl='onepass', oracle=None):
    """One update + BA iteration over the existing pairs (terminate() runs
    this 12 times — reference dpvo.py:181-183)."""
    _update_ba(network, st, st.n, M=M, W=W, PCF=PCF, iterations=1,
               corr_impl=corr_impl, oracle=oracle)
    return st


# ---------------------------------------------------------------------------
# ingest and the chunked step
# ---------------------------------------------------------------------------

def i420_to_rgb(planes, ht, wd):
    """I420 planes (flat uint8: Y (ht, wd), then U and V (ht/2, wd/2)) ->
    (ht, wd, 3) f32 RGB in [0, 255]: video-range BT.601 with 2x2 nearest
    chroma, as dpvo_tpu/runtime/device_vo.py:_i420_to_rgb; within one unit
    of cv2.COLOR_YUV2RGB_I420, which rounds to uint8."""
    n = ht * wd
    q = n // 4
    y = planes[:n].reshape(ht, wd).float()

    def up2(c):                                   # 2x2 nearest upsample
        c = c.reshape(ht // 2, 1, wd // 2, 1).float() - 128.0
        return c.expand(ht // 2, 2, wd // 2, 2).reshape(ht, wd)

    U, V = up2(planes[n:n + q]), up2(planes[n + q:n + 2 * q])
    yv = 1.164 * (y - 16.0)
    r = yv + 1.596 * V
    g = yv - 0.392 * U - 0.813 * V
    b = yv + 2.017 * U
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def unpack_frame(buf, *, ht, wd, M, upload='rgb'):
    """(image, aux) of one flat uint8 upload row [image bytes (rgb: 3,
    yuv420: 1.5 per pixel) | (M, 4) f32 aux bytes]. The aux bytes are
    reinterpreted in place where their offset in the storage is a multiple
    of 4, else copied first."""
    npix = ht * wd * 3 if upload == 'rgb' else ht * wd * 3 // 2
    if upload == 'rgb':
        image = buf[:npix].view(ht, wd, 3)
    else:
        image = i420_to_rgb(buf[:npix], ht, wd)
    tail = buf[npix:npix + 16 * M]
    if tail.storage_offset() % 4:
        tail = tail.clone()
    return image, tail.view(torch.float32).view(M, 4)


def vo_frame_packed(network, st, image, aux, **kw):
    """vo_frame with the (M, 4) aux packed [x, y, depth seed, tstamp]
    (dpvo_tpu's vo_frame_packed): vo_frame itself takes that layout."""
    return vo_frame(network, st, image, aux, **kw)


def vo_frame_packed1(network, st, buf, *, ht, wd, upload='rgb', **kw):
    """vo_frame from one flat uint8 upload (dpvo_tpu's vo_frame_packed1),
    laid out as unpack_frame reads it."""
    image, aux = unpack_frame(buf, ht=ht, wd=wd, M=kw['M'], upload=upload)
    return vo_frame(network, st, image, aux, **kw)


def vo_frames(network, st, images, coords, depth_seeds, tstamps, **kw):
    """Track a chunk of K frames: vo_frame over each, in order (dpvo_tpu's
    vo_frames). images (K, H, W, 3); coords (K, M, 2) f32; depth_seeds
    (K, M) f32; tstamps (K,) f32.

    The math is vo_frame's, frame by frame, and so are its host reads:
    none from the bootstrap frame on, so the K frames are enqueued without
    waiting for the device; before it, without force_accept, the motion
    probe's accept decision once per frame. dpvo_tpu scans the chunk in
    one dispatch; here each frame's kernels are launched in turn."""
    M = kw['M']
    for k in range(images.shape[0]):
        aux = torch.cat([coords[k], depth_seeds[k][:, None],
                         tstamps[k].reshape(1, 1).expand(M, 1)], dim=1)
        st = vo_frame(network, st, images[k], aux, **kw)
    return st


def vo_frames_packed(network, st, images, aux, **kw):
    """vo_frames with the per-frame aux packed as (K, M, 4)."""
    for k in range(images.shape[0]):
        st = vo_frame(network, st, images[k], aux[k], **kw)
    return st
