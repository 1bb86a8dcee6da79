"""Operations of one DeviceVO frame, counted from shapes, and the card's
published peaks (NVIDIA H100 SXM data sheet, dense, at its 700 W limit).

A frame runs both encoders once at the frame's resolution, then the
update operator, K1 and two Gauss-Newton steps of bundle adjustment once
per update iteration (one, once initialized). The work counted is what
the live edges need: the runtime computes its fixed-size table whole and
masks the dead edges, which is work this count leaves out.
"""
from __future__ import annotations

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def encoder_flops(H, W, enc_dim, out_dim):
    """Multiply-adds x 2 of one BasicEncoder4 on an H x W frame: the 7x7
    stride-2 conv, two residual stages (the second stride 2 with a 1x1
    projection), the 1x1 output conv. Norms and ReLUs are not counted."""
    e = enc_dim
    h2, w2 = H // 2, W // 2
    h4, w4 = H // 4, W // 4
    conv = [(3, e, 7, h2 * w2)]
    conv += [(e, e, 3, h2 * w2)] * 4
    conv += [(e, 2 * e, 3, h4 * w4), (2 * e, 2 * e, 3, h4 * w4),
             (e, 2 * e, 1, h4 * w4)]
    conv += [(2 * e, 2 * e, 3, h4 * w4)] * 2
    conv += [(2 * e, out_dim, 1, h4 * w4)]
    return sum(2 * ci * co * k * k * px for ci, co, k, px in conv)


def update_flops(edges, pairs, groups, dim, corr_in):
    """One update operator over `edges` live edges in `pairs` frame pairs
    with `groups` distinct source patches: the correlation MLP (3
    linears), the two neighbour MLPs (2 each), both aggregations' f and g
    per edge and h per group, the two gated residual units (3 each) and
    the two heads."""
    d2 = dim * dim
    per_edge = corr_in * dim + 2 * d2          # corr.0, corr.2, corr.5
    per_edge += 4 * d2                         # c1, c2
    per_edge += 4 * d2                         # agg_kk and agg_ij f, g
    per_edge += 6 * d2                         # gru: gate, res.0, res.2 x 2
    per_edge += 2 * dim * 2                    # heads d, w
    return 2 * (edges * per_edge + (groups + pairs) * d2)


def k1_flops(nv):
    """K1's tap dots (8x8 integer taps, 9 patch pixels, 128 channels,
    both levels) and bilinear combination for nv live edges."""
    return 2 * nv * 9 * 64 * 128 * 2 + nv * 9 * 49 * 7 * 2


def ba_flops(edges, W, PC, steps=2):
    """`steps` Gauss-Newton steps over `edges` live edges: the pose
    blocks' and the pose-depth products per edge (2 residuals), the Schur
    complement over PC depths, its Cholesky and solve."""
    per_edge = 3 * 2 * 6 * 6 * 2 + 2 * 2 * 6 * 2 + 3 * 2 * 2
    n = 6 * W
    schur = 2 * n * n * PC + 2 * n * PC + n ** 3 // 3 + 2 * n * n
    return steps * (edges * per_edge + schur)


def frame_flops(config, edges, iterations=1):
    """Operations of one steady frame of `config` with `edges` live
    edges (live pairs x M)."""
    net, dp = config['network'], config['dpvo']
    M = dp['PATCHES_PER_FRAME']
    H, W = config['height'], config['width']
    corr_in = net['corr_levels'] * (2 * net['corr_radius'] + 1) ** 2 \
        * net['patch'] ** 2
    pairs = edges / M
    groups = M * (dp['REMOVAL_WINDOW'] + 1)
    enc = encoder_flops(H, W, net['enc_dim'], net['fdim']) + \
        encoder_flops(H, W, net['enc_dim'], net['dim'])
    per_iter = update_flops(edges, pairs, groups, net['dim'], corr_in) + \
        k1_flops(edges) + ba_flops(edges, dp['OPTIMIZATION_WINDOW'],
                                   (dp['REMOVAL_WINDOW'] + 4) * M)
    return enc + iterations * per_iter
