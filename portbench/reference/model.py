"""VONet in plain PyTorch, functional, on a dict of weights (reference
dpvo/net.py, dpvo/extractor.py, dpvo/blocks.py).

Computes in float32 (TF32 off: portbench.reference.plain_numerics) unless
given a quantizer `q`, which every conv and linear applies to its input
and weight, and `store` applies to what the runtime keeps between frames
(feature maps, patch features, the pair table's hidden state): the
control's lower precision (reference/precision.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _same(t):
    return t


class Net:
    """The network on weights `w` ({state_dict name: f32 tensor}); `q` /
    `store` as the module docstring says (identity for the reference)."""

    def __init__(self, w, P=3, q=_same, store=_same):
        self.w, self.P, self.q, self.store = w, P, q, store

    # ---------------- layers ---------------- #
    def conv(self, x, name, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(self.w[name + '.weight']),
                        self.w[name + '.bias'], stride=stride,
                        padding=padding)

    def lin(self, x, name):
        return F.linear(self.q(x), self.q(self.w[name + '.weight']),
                        self.w[name + '.bias'])

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + '.weight'],
                            self.w[name + '.bias'], 1e-3)

    @staticmethod
    def inorm(x):
        return F.instance_norm(x, eps=1e-5)

    def encoder(self, x, pre, instance):
        nrm = self.inorm if instance else _same

        def block(x, name, stride):
            y = F.relu(nrm(self.conv(x, name + '.conv1', stride, 1)))
            y = F.relu(nrm(self.conv(y, name + '.conv2', 1, 1)))
            if stride != 1:
                x = nrm(self.conv(x, name + '.downsample.0', stride))
            return F.relu(x + y)

        x = F.relu(nrm(self.conv(x, pre + '.conv1', 2, 3)))
        x = block(block(x, pre + '.layer1.0', 1), pre + '.layer1.1', 1)
        x = block(block(x, pre + '.layer2.0', 2), pre + '.layer2.1', 1)
        return self.conv(x, pre + '.conv2')

    # ---------------- patchify ---------------- #
    def patchify(self, image, coords):
        """One frame: image (H, W, 3) f32 normalized 2 I / 255 - 0.5,
        coords (M, 2) patch centroids at 1/4 scale. Returns fmap1 (H/4,
        W/4, C), fmap2 (H/16, W/16, C), gmap (M, P, P, C), imap (M, D),
        clr (M, 3), each through `store` but clr."""
        x = image.permute(2, 0, 1)[None]
        fmap = (self.encoder(x, 'patchify.fnet', True) / 4.0)[0] \
            .permute(1, 2, 0)
        imap = (self.encoder(x, 'patchify.inet', False) / 4.0)[0] \
            .permute(1, 2, 0)
        fmap, imap = self.store(fmap), self.store(imap)
        gmap = patches(fmap, coords, self.P // 2)
        imp = patches(imap, coords, 0)[:, 0, 0]
        clr = patches(image, 4.0 * (coords + 0.5), 0)[:, 0, 0]
        H, W, C = fmap.shape
        fmap2 = fmap.reshape(H // 4, 4, W // 4, 4, C).mean(dim=(1, 3))
        return dict(fmap1=fmap, fmap2=self.store(fmap2),
                    gmap=self.store(gmap), imap=self.store(imp),
                    clr=(clr + 0.5) * (255.0 / 2))

    # ---------------- update operator ---------------- #
    def update(self, net, inp, corr, ix_pair, jx_pair, psl, mask3, pmem):
        """One recurrent update over a pair-blocked edge table: net / inp
        (GP*M, D), corr (GP*M, 882), ix_pair / jx_pair (GP,) the pair with
        the same source frame and the previous / next target frame (-1:
        none), psl (GP,) each pair's source ring slot, mask3 (GP, M) the
        live edges, pmem ring slots. Returns (net', delta (GP*M, 2),
        weight (GP*M, 2))."""
        u = 'update'
        GP, M = mask3.shape
        D = net.shape[-1]
        c = self.lin(F.relu(self.lin(corr, f'{u}.corr.0')), f'{u}.corr.2')
        c = self.lin(F.relu(self.ln(c, f'{u}.corr.3')), f'{u}.corr.5')
        net = self.ln(net + inp + c, f'{u}.norm')

        def neighbor(x, idx):
            ok = ((idx >= 0)[:, None] & mask3).reshape(GP * M, 1)
            got = x.reshape(GP, M * D)[idx.clamp(min=0)].reshape(GP * M, D)
            return torch.where(ok, got, 0.0)

        def mlp(x, name):
            return self.lin(F.relu(self.lin(x, name + '.0')), name + '.2')

        net = net + mlp(neighbor(net, ix_pair), f'{u}.c1')
        net = net + mlp(neighbor(net, jx_pair), f'{u}.c2')
        net = net + self._agg_kk(net.reshape(GP, M, D), psl, mask3, pmem)
        net = net + self._agg_ij(net.reshape(GP, M, D), mask3)
        for ln, gr in (('gru.0', 'gru.1'), ('gru.2', 'gru.3')):
            x = self.ln(net, f'{u}.{ln}')
            gate = torch.sigmoid(self.lin(x, f'{u}.{gr}.gate.0'))
            net = x + gate * mlp(x, f'{u}.{gr}.res')
        delta = self.lin(F.relu(net), f'{u}.d.1')
        weight = torch.sigmoid(self.lin(F.relu(net), f'{u}.w.1'))
        return net, delta, weight

    def _agg_kk(self, x3, psl, mask3, pmem):
        """Softmax aggregation over the edges of each source patch (ring
        slot psl[g], patch m), re-expanded to the edges."""
        GP, M, D = x3.shape
        name = 'update.agg_kk'
        fx, gx = self.lin(x3, name + '.f'), self.lin(x3, name + '.g')
        keep = (mask3 & ((psl >= 0) & (psl < pmem))[:, None])[..., None]
        slot = psl.clamp(0, pmem - 1)
        gxm = torch.where(keep, gx, -1e30)
        idx = slot[:, None, None].expand(GP, M, D)
        mx = torch.full((pmem, M, D), -1e30, device=x3.device).scatter_reduce(
            0, idx, gxm, reduce='amax', include_self=True)
        ex = torch.where(keep, torch.exp(gxm - mx[slot]), 0.0)
        den = torch.zeros((pmem, M, D), device=x3.device).index_add_(0, slot,
                                                                     ex)
        w = ex / den[slot].clamp(min=1e-30)
        y = torch.zeros((pmem, M, D), device=x3.device).index_add_(
            0, slot, fx * w)
        return self.lin(y, name + '.h')[slot].reshape(GP * M, D)

    def _agg_ij(self, x3, mask3):
        """Softmax aggregation over the M edges of each frame pair."""
        GP, M, D = x3.shape
        name = 'update.agg_ij'
        fx, gx = self.lin(x3, name + '.f'), self.lin(x3, name + '.g')
        keep = mask3[..., None]
        gxm = torch.where(keep, gx, float('-inf'))
        mx = gxm.amax(dim=1, keepdim=True)
        ex = torch.where(keep, torch.exp(gxm - torch.where(
            torch.isfinite(mx), mx, 0.0)), 0.0)
        w = ex / ex.sum(dim=1, keepdim=True).clamp(min=1e-30)
        y = (fx * w).sum(dim=1)
        hy = self.lin(y, name + '.h')
        return hy[:, None].expand(GP, M, D).reshape(GP * M, D)


def patches(fmap, coords, radius):
    """(M, 2R+1, 2R+1, C) bilinear patches of fmap (H, W, C) at float
    centroids coords (M, 2) [x, y]; taps outside the map are 0."""
    H, W, C = fmap.shape
    D = 2 * radius + 2
    x0 = torch.floor(coords[:, 0]).long() - radius
    y0 = torch.floor(coords[:, 1]).long() - radius
    ar = torch.arange(D, device=fmap.device)
    yi, xj = y0[:, None] + ar, x0[:, None] + ar
    valid = ((yi[:, :, None] >= 0) & (yi[:, :, None] < H) &
             (xj[:, None, :] >= 0) & (xj[:, None, :] < W))
    win = fmap[yi.clamp(0, H - 1)[:, :, None], xj.clamp(0, W - 1)[:, None, :]]
    win = torch.where(valid[..., None], win, 0.0)
    fr = coords - torch.floor(coords)
    dx = fr[:, 0, None, None, None]
    dy = fr[:, 1, None, None, None]
    d = 2 * radius + 1
    return ((1 - dy) * (1 - dx) * win[:, :d, :d] +
            (1 - dy) * dx * win[:, :d, 1:] +
            dy * (1 - dx) * win[:, 1:, :d] + dy * dx * win[:, 1:, 1:])
