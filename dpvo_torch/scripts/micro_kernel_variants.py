"""12x16-window planes at both levels, and the same at a fixed window, on
the card (K8).

    python -m dpvo_torch.scripts.micro_kernel_variants [--scale S] [--seed N]

Counterpart of scripts/micro_kernel_variants.py. Its modes full, twodots
and rank3 compute the same planes and differed only in TPU layout: here
they are one kernel instantiation (w12x16); fixedw puts every edge's
windows at (0, 0) of its frame. At scale 1 its sizes: E = 49,152 edges, 36
frames of 120x160 / 30x40 bf16 maps (edges on the first 30, sorted), 12x16
windows in the map at the script's bases (level 1 x a multiple of 8 plus
the phase, 4 * ph; level 2 x = 4 * ph), bf16 out (E, 9, 192) per level.
Each variant is held against its plain version; times are CUDA-event
medians of 20 (the card only).
"""
from __future__ import annotations

import numpy as np

from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import _common as cm

H1, W1 = 120, 160
H2, W2 = H1 // 4, W1 // 4
F0 = 36
E0 = 49152
JJ_MAX = 30            # the script's edges use frames 0 .. 29
WY, WX = cp.WV
C, P2 = cm.C, cp.P2
SCRIPT = 'scripts/micro_kernel_variants.py'


def main(device='cuda', scale=1.0, seed=0):
    """Runs w12x16 and fixedw against their plain versions; returns
    {'E', 'F', 'variants': {name: row}}."""
    dev = cm.device(device)
    E = cm.scaled(E0, scale, 32)
    F = max(2, round(F0 * scale))
    rng = np.random.default_rng(seed)
    g9 = cm.normal(rng, (E, P2, C), dev)
    fmap1 = cm.normal(rng, (F, H1, W1, C), dev)
    fmap2 = cm.normal(rng, (F, H2, W2, C), dev)
    jj = cm.ints(np.sort(rng.integers(0, min(JJ_MAX, F), E)), dev)
    by1 = cm.ints(rng.integers(0, H1 - WY, E), dev)
    bx1 = cm.ints(rng.integers(0, (W1 - WX) // 8, E) * 8 +
                  4 * rng.integers(0, 2, E), dev)
    by2 = cm.ints(rng.integers(0, H2 - WY, E), dev)
    bx2 = cm.ints(4 * rng.integers(0, 2, E), dev)
    print(f'micro_kernel_variants: E = {E}, F = {F}, maps {H1}x{W1} / '
          f'{H2}x{W2}, windows {WY}x{WX}', flush=True)

    n = WY * WX
    out_b = 2 * E * P2 * n * 2
    flops = 2 * E * P2 * 2 * n * C
    args = (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    rows = {}
    rows['planes_w12x16'] = cm.run(
        'planes_w12x16 (K8 full / twodots / rank3)', 'planes_w12x16',
        f'{SCRIPT}:42', lambda: cp.planes_w12x16(*args),
        lambda: cp.planes_w12x16_plain(*args),
        cm.nbytes(g9, jj, by1, bx1, by2, bx2) + out_b +
        cm.map_bytes(jj, *cm.window_yx(by1, bx1, WX, n), F, H1, W1) +
        cm.map_bytes(jj, *cm.window_yx(by2, bx2, WX, n), F, H2, W2),
        flops, dev)
    z = by1.new_zeros(E)
    rows['planes_fixedw'] = cm.run(
        'planes_fixedw (K8 fixedw)', 'planes_fixedw', f'{SCRIPT}:42',
        lambda: cp.planes_fixedw(g9, fmap1, fmap2, jj),
        lambda: cp.planes_fixedw_plain(g9, fmap1, fmap2, jj),
        cm.nbytes(g9, jj) + out_b +
        cm.map_bytes(jj, *cm.window_yx(z, z, WX, n), F, H1, W1) +
        cm.map_bytes(jj, *cm.window_yx(z, z, WX, n), F, H2, W2),
        flops, dev)
    return dict(E=E, F=F, variants=rows)


if __name__ == '__main__':
    cm.cli(main, __doc__)
