"""K2's planes as target tiles (K4) and rolled per edge (K5), on the card.

    python -m dpvo_torch.scripts.micro_fused_v2 [--scale S] [--seed N]

Counterpart of scripts/micro_fused_v2.py (v1 K=2 pairing, v2 dealign
roll). At scale 1 its sizes: E = 43,008 edges, 16 target frames of 120x160
(level 1) and 30x40 (level 2) bf16 maps, 128 channels, coords spread over
the image with a +-1 px jitter per patch pixel, edges sorted by target.
Also runs the script's v0, K2 itself (ops/corr_fused.planes, one edge per
block on the CUDA cores), and v3, K3's tap select of both levels on K2's
planes, on the same inputs. The script's XLA select (`sel`) and its
corr_fused with that select have no counterpart: the port has one select,
K3. Each variant is held against its plain version; times are CUDA-event
medians of 20 (the card only). On the card it also prints what K4's chain
reads from L2 per call (the work items its chain made, read back by
ops/corr_probes.py:pair_work: edges per item, staged tiles and g rows) and
times K5 against K4 in turns.
"""
from __future__ import annotations

import numpy as np
import torch

from dpvo_torch.ops import corr_fused
from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import _common as cm

H, W = 120, 160
H2, W2 = H // 4, W // 4
F0 = 16
E0 = 43008
C, P2 = cm.C, cp.P2
SCRIPT = 'scripts/micro_fused_v2.py'


def roll_shifts(xi1, bx1, xi2, bx2):
    """The probe's per-edge roll (scripts/micro_fused_v2.py:240-246) in
    image coordinates. Level 1: sh1 = min(xi1) - 3 - bx1, the x alignment
    slack. Level 2: sh2 = min(xi2) - 3 - (bx2 - 4 * ph2), ph2 = (bx2 // 4)
    % 2: the script measures from the phase slab's base, not the window's,
    so for phase-1 edges sh2 overshoots the slack by 4 (kept as the script
    has it). int32 (E,) each."""
    ph2 = torch.remainder(torch.div(bx2, 4, rounding_mode='floor'), 2)
    sh1 = xi1.amin(1) - 3 - bx1
    sh2 = xi2.amin(1) - 3 - (bx2 - 4 * ph2)
    return sh1.int(), sh2.int()


def inputs(dev, scale=1.0, seed=0):
    """The probe's seeded inputs on dev: E, F, the planes' arguments
    `args` (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2), the rolls sh1, sh2
    and K2's / K3's window rules w1, w2 (ops/corr_fused.window_base)."""
    E = cm.scaled(E0, scale, 32)
    F = max(2, round(F0 * scale))
    rng = np.random.default_rng(seed)
    fmap1 = cm.normal(rng, (F, H, W, C), dev)
    fmap2 = cm.normal(rng, (F, H2, W2, C), dev)
    g9 = cm.normal(rng, (E, P2, C), dev)
    jj = cm.ints(np.sort(rng.integers(0, F, E)), dev)
    cx = rng.uniform(4, W - 5, (E, 1, 1)) + rng.uniform(-1, 1, (E, 3, 3))
    cy = rng.uniform(4, H - 5, (E, 1, 1)) + rng.uniform(-1, 1, (E, 3, 3))
    coords = torch.from_numpy(np.stack([cx, cy], -1).astype(np.float32)).to(
        dev)
    w1 = corr_fused.window_base(coords, H, W, 8)
    w2 = corr_fused.window_base(coords / 4.0, H2, W2, 4)
    xi1, by1, bx1 = w1[0], w1[4], w1[5]
    xi2, by2, bx2 = w2[0], w2[4], w2[5]
    sh1, sh2 = roll_shifts(xi1, bx1, xi2, bx2)
    return dict(E=E, F=F, args=(g9, fmap1, fmap2, jj, by1, bx1, by2, bx2),
                sh=(sh1, sh2), w1=w1, w2=w2)


def main(device='cuda', scale=1.0, seed=0):
    """Runs K4 and K5 (and K2, K3 for reference) against their plain
    versions, and on the card K5 and K4 in turns (device time); returns
    {'E', 'F', 'variants': {name: row}, 'reference': {name: row},
    'paired': {'planes_roll / planes_pair': _common.paired's dict},
    'pair_work': on the card the work items of one call of K4's chain
    (pair_work), 'pair_stats': its items and bytes from L2
    (corr_probes.tile_stats); None off the card}."""
    dev = cm.device(device)
    inp = inputs(dev, scale, seed)
    E, F, args, (sh1, sh2), w1, w2 = (inp[k] for k in ('E', 'F', 'args',
                                                       'sh', 'w1', 'w2'))
    g9, fmap1, fmap2, jj, by1, bx1, by2, bx2 = args
    print(f'micro_fused_v2: E = {E}, F = {F}, maps {H}x{W} / {H2}x{W2}',
          flush=True)

    n1, n2 = cp.WY * cp.WX, cp.WY2 * cp.WX2
    nb = (cm.nbytes(g9, jj, by1, bx1, by2, bx2) + E * P2 * (n1 + n2) * 2 +
          cm.map_bytes(jj, *cm.window_yx(by1, bx1, cp.WX, n1), F, H, W) +
          cm.map_bytes(jj, *cm.window_yx(by2, bx2, cp.WX2, n2), F, H2, W2))
    flops = 2 * E * P2 * (n1 + n2) * C
    rows = {}
    rows['planes_pair'] = cm.run(
        'planes_pair (K4)', 'planes_pair', f'{SCRIPT}:93',
        lambda: cp.planes_pair(*args), lambda: cp.planes_pair_plain(*args),
        nb, flops, dev)
    rows['planes_roll'] = cm.run(
        'planes_roll (K5)', 'planes_roll', f'{SCRIPT}:174',
        lambda: cp.planes_roll(*args, sh1, sh2),
        lambda: cp.planes_roll_plain(*args, sh1, sh2),
        nb + cm.nbytes(sh1, sh2), flops, dev)

    # v0, K2 on the same inputs (g rows through kk = e), and v3, K3 on its
    # planes
    kk = torch.arange(E, dtype=torch.int32, device=dev)
    k2 = (g9, fmap1, fmap2, kk, jj, by1, bx1, by2, bx2)
    ref = dict(corr_planes=cm.run(
        'corr_planes (K2, v0)', None, 'dpvo_tpu/ops/corr_fused.py:94',
        lambda: [p.reshape(E, P2, -1) for p in corr_fused.planes(*k2)],
        lambda: cp.planes_pair_plain(*args), nb + cm.nbytes(kk), flops, dev))
    planes = corr_fused.planes(*k2)
    sel = [(p, w[1], w[0], w[3], w[2], w[6], w[7], *hw)      # yi xi fy fx
           for p, w, hw in ((planes[0], w1, (H, W)),         # oy ox H W
                            (planes[1], w2, (H2, W2)))]
    # per tap: the four validity-folded weights (6 operations) and the
    # bilinear (6); the planes, six per-pixel arrays and the f32 taps moved
    ref['select_taps'] = cm.run(
        'select_taps (K3, v3, both levels)', None,
        'dpvo_tpu/ops/corr_select.py:63',
        lambda: [corr_fused.select_taps(*a) for a in sel],
        lambda: [corr_fused.select_plain(*a) for a in sel],
        sum(cm.nbytes(*a[:7]) for a in sel) + 2 * E * 441 * 4,
        2 * E * 441 * 12, dev)
    paired, work, st = {}, None, None
    if dev.type == 'cuda':
        work = cp.pair_work(*args)
        st = cp.tile_stats(work)
        print(f'  planes_pair (K4) reads per call: {st["items"]} work items, '
              f'{st["edges_per_item"]!r} edges per item, tiles '
              f'{st["tile_bytes"] / 1e9!r} GB and g rows '
              f'{st["g_bytes"] / 1e9!r} GB from L2 (each edge reading its '
              f'own windows: {E * (n1 + n2) * C * 2 / 1e9!r} GB)', flush=True)
        copied = (int(cp.ring_rows('planes_roll', jj, by1, bx1, by2, bx2, F,
                                   H, W, H2, W2).sum()) + E * P2) * C * 2
        paired['planes_roll / planes_pair'] = cm.paired(
            ('planes_roll (K5)', lambda: cp.planes_roll(*args, sh1, sh2),
             copied), ('planes_pair (K4)', lambda: cp.planes_pair(*args),
                       st['tile_bytes'] + st['g_bytes']))
    return dict(E=E, F=F, variants=rows, reference=ref, paired=paired,
                pair_work=work, pair_stats=st)


if __name__ == '__main__':
    cm.cli(main, __doc__)
