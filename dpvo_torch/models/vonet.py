"""VONet: patch extraction front-end + recurrent update operator.

Port of dpvo_tpu/models/vonet.py (reference dpvo/net.py: Update :27-92,
Patchifier :95-157, VONet :176-272) as nn.Modules whose state_dict keys are
the reference names ('patchify.fnet.conv1.weight', 'update.corr.0.weight',
...). The compute dtype is the parameters' dtype: call .to(torch.bfloat16)
for MIXED_PRECISION. Feature maps leave patchify_frame channels-last.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.patchify import avg_pool2d, extract_patches
from .blocks import GatedResidual, LayerNorm32, SoftAgg
from .checkpoint import init_vonet_params, load_network, state_dict_from_jax
from .extractor import BasicEncoder4

P = 3
DIM = 384
RES = 4
CORR_IN = 2 * 49 * P * P  # two pyramid levels x 7x7 window x 3x3 patch


class Patchifier(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.fnet = BasicEncoder4(128, 'instance', device)
        self.inet = BasicEncoder4(DIM, 'none', device)


class Update(nn.Module):
    def __init__(self, device=None):
        super().__init__()

        def lin(i, o):
            return nn.Linear(i, o, device=device)

        self.c1 = nn.Sequential(lin(DIM, DIM), nn.ReLU(), lin(DIM, DIM))
        self.c2 = nn.Sequential(lin(DIM, DIM), nn.ReLU(), lin(DIM, DIM))
        self.norm = LayerNorm32(DIM, eps=1e-3, device=device)
        self.agg_kk = SoftAgg(DIM, device)
        self.agg_ij = SoftAgg(DIM, device)
        self.gru = nn.Sequential(
            LayerNorm32(DIM, eps=1e-3, device=device), GatedResidual(DIM, device),
            LayerNorm32(DIM, eps=1e-3, device=device), GatedResidual(DIM, device))
        self.corr = nn.Sequential(
            lin(CORR_IN, DIM), nn.ReLU(), lin(DIM, DIM),
            LayerNorm32(DIM, eps=1e-3, device=device), nn.ReLU(), lin(DIM, DIM))
        # the heads' sigmoid runs in f32 in update_op
        self.d = nn.Sequential(nn.ReLU(), lin(DIM, 2))
        self.w = nn.Sequential(nn.ReLU(), lin(DIM, 2))


class VONet(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.patchify = Patchifier(device)
        self.update = Update(device)

    @property
    def dtype(self):
        return self.update.norm.weight.dtype

    def patchify_frame(self, image, coords):
        """Run both encoders on one frame and gather patch features.

        image (H, W, 3) normalized 2*(I/255)-0.5; coords (M, 2) f32 patch
        centroids at 1/RES scale. Returns dict with fmap1 (H/4, W/4, 128),
        fmap2 (H/16, W/16, 128), gmap (M, P, P, 128), imap (M, DIM),
        patch_xy (M, 2, P, P), clr (M, 3) f32."""
        x = image.permute(2, 0, 1)[None].to(self.dtype)
        fmap = (self.patchify.fnet(x)[0] / 4.0).permute(1, 2, 0)
        imap = (self.patchify.inet(x)[0] / 4.0).permute(1, 2, 0)

        gmap = extract_patches(fmap, coords, P // 2)
        imap_p = extract_patches(imap, coords, 0)[:, 0, 0, :]

        off = torch.arange(-(P // 2), P // 2 + 1, dtype=torch.float32,
                           device=coords.device)
        M = coords.shape[0]
        gx = (coords[:, 0, None, None] + off[None, None, :]).expand(M, P, P)
        gy = (coords[:, 1, None, None] + off[None, :, None]).expand(M, P, P)
        patch_xy = torch.stack([gx, gy], dim=1)

        # color at full resolution (net.py:143): bilinear at 4*(coords+0.5)
        clr = extract_patches(image, 4.0 * (coords + 0.5), 0)[:, 0, 0, :]
        clr = (clr.float() + 0.5) * (255.0 / 2)

        fmap1 = fmap.contiguous()
        return dict(fmap1=fmap1, fmap2=avg_pool2d(fmap1, 4), gmap=gmap,
                    imap=imap_p, patch_xy=patch_xy, clr=clr)

    def update_op(self, net, inp, corr_feat, ix, jx, kk_ids, pair_ids,
                  num_segments, edge_mask, num_segments_kk=None,
                  num_segments_ij=None, gather_pairs=None):
        """One recurrent update over all edges (dpvo_tpu update_op).

        net / inp (E, DIM); corr_feat (E, CORR_IN); ix / jx (E,) temporal
        neighbor edges, -1 if none; kk_ids / pair_ids (E,) dense group ids;
        edge_mask (E,) bool. gather_pairs = (ix_pair, jx_pair, M) selects the
        pair-blocked form (edges come as GP pairs x M patches): neighbor
        gathers and both aggregations then run at pair granularity.
        Returns (net', delta (E, 2) f32, weight (E, 2) f32)."""
        if num_segments_kk is None:
            num_segments_kk = num_segments
        if num_segments_ij is None:
            num_segments_ij = num_segments
        u = self.update
        dt = self.dtype
        net = net.to(dt) + inp.to(dt) + u.corr(corr_feat.to(dt))
        net = u.norm(net)

        mask_ix = ((ix >= 0) & edge_mask)[:, None].to(dt)
        mask_jx = ((jx >= 0) & edge_mask)[:, None].to(dt)

        def neighbor(x, idx_e, idx_pair):
            if gather_pairs is None:
                return x[idx_e.clamp(min=0)]
            Mg = gather_pairs[2]
            xp = x.reshape(-1, Mg * x.shape[-1])
            return xp[idx_pair.clamp(min=0)].reshape(x.shape)

        # sequential: c2's gather sees the c1-updated state (net.py:80-85)
        gp = gather_pairs or (None, None, None)
        net = net + u.c1(mask_ix * neighbor(net, ix, gp[0]))
        net = net + u.c2(mask_jx * neighbor(net, jx, gp[1]))

        if gather_pairs is not None:
            Mg = gather_pairs[2]
            GP = net.shape[0] // Mg
            mask3 = edge_mask.reshape(GP, Mg)
            psl = kk_ids.reshape(GP, Mg)[:, 0] // Mg
            net = net + u.agg_kk.kk_pairs(net.reshape(GP, Mg, DIM), psl,
                                          mask3, num_segments_kk // Mg)
            net = net + u.agg_ij.ij_pairs(net.reshape(GP, Mg, DIM), mask3)
        else:
            net = net + u.agg_kk(net, kk_ids, num_segments_kk, mask=edge_mask)
            net = net + u.agg_ij(net, pair_ids, num_segments_ij,
                                 mask=edge_mask)

        net = u.gru(net)
        delta = u.d(net).float()
        weight = torch.sigmoid(u.w(net).float())
        return net, delta, weight


def load_vonet(network, device, mixed_precision):
    """VONet on `device` with weights from a .pth / .npz path, or the
    seeded random init (init_vonet_params(0)) for None / 'none' / 'random'.
    bf16 parameters under mixed precision; inference only."""
    if network is None or network in ('', 'none', 'random'):
        sd = state_dict_from_jax(init_vonet_params(0))
    else:
        sd = load_network(network)
    net = VONet(device=device)
    net.load_state_dict(sd)
    if mixed_precision:
        net.to(torch.bfloat16)
    return net.eval().requires_grad_(False)
