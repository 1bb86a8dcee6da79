"""Small-dot floor of the correlation, on the card (K6).

    python -m dpvo_torch.scripts.micro_corr_floor [--scale S] [--seed N]

Counterpart of scripts/micro_corr_floor.py. At scale 1 its sizes: E =
49,152 edges, g9 (E, 9, 128) bf16,
  dots   per edge (9, 128) x (128, 384) from pre-gathered windows (E, 384,
         128) bf16 (4.83 GB), f32 out; beside it one torch.bmm with f32
         output as the library yardstick;
  dots2  the same reading the first 256 rows of each window, bf16 out;
         yardstick torch.bmm on the strided view;
  slab   a 16x16 window per edge sliced from one resident 120x160 map,
         bf16 out: window y in [0, 104), x a multiple of 8 in [0, 144).
Each variant is held against its plain version; times are CUDA-event
medians of 20 launches, each timed alone (the card only). dots and dots2
are also timed in turns with their torch.bmm, 5 rounds of 20 back-to-back
launches of each, and the kernel / library ratio is printed.
"""
from __future__ import annotations

import numpy as np
import torch

from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import _common as cm

E0 = 49152
H4, W4 = 120, 160
C, P2 = cm.C, cp.P2
SCRIPT = 'scripts/micro_corr_floor.py'


def _bmm_f32(g9, win):
    """torch.bmm with bf16 inputs and f32 output, in the closest form this
    PyTorch has: out_dtype where it exists, else bf16 out converted.
    Returns (fn, its description)."""
    wt = win.transpose(1, 2)
    try:
        torch.bmm(g9[:1], wt[:1], out_dtype=torch.float32)
        return (lambda: torch.bmm(g9, wt, out_dtype=torch.float32),
                'torch.bmm(g9, win^T, out_dtype=torch.float32)')
    except (TypeError, RuntimeError, NotImplementedError):
        return (lambda: torch.bmm(g9, wt).float(),
                'torch.bmm(g9, win^T).float(): bf16 out, no out_dtype')


def main(device='cuda', scale=1.0, seed=0):
    """Runs dots, dots2 and slab against their plain versions; returns
    {'E', 'variants': {name: row}}."""
    dev = cm.device(device)
    E = cm.scaled(E0, scale, 16)
    rng = np.random.default_rng(seed)
    g9 = cm.normal(rng, (E, P2, C), dev)
    win = cm.normal(rng, (E, cp.DOTS_W, C), dev)
    fmap = cm.normal(rng, (H4, W4, C), dev)
    by = cm.ints(rng.integers(0, H4 - cp.SLAB, E), dev)
    bx = cm.ints(rng.integers(0, (W4 - cp.SLAB) // 8, E) * 8, dev)
    print(f'micro_corr_floor: E = {E}, windows {cp.DOTS_W} x {C}, slab '
          f'{H4}x{W4}', flush=True)

    rows = {}
    w, w2 = cp.DOTS_W, cp.DOTS2_W
    lib, form = _bmm_f32(g9, win)
    rows['dots'] = cm.run(
        'dots (K6 dot_kernel)', 'dots', f'{SCRIPT}:59',
        lambda: cp.dots(g9, win), lambda: cp.dots_plain(g9, win),
        cm.nbytes(g9, win) + E * P2 * w * 4, 2 * E * P2 * w * C, dev,
        library=lib, library_form=form)
    head = win[:, :w2].transpose(1, 2)
    rows['dots2'] = cm.run(
        'dots2 (K6 dot_kernel2)', 'dots2', f'{SCRIPT}:91',
        lambda: cp.dots2(g9, win), lambda: cp.dots2_plain(g9, win),
        cm.nbytes(g9) + E * w2 * C * 2 + E * P2 * w2 * 2,
        2 * E * P2 * w2 * C, dev, library=lambda: torch.bmm(g9, head),
        library_form='torch.bmm(g9, win[:, :256]^T), bf16 out')
    n = cp.SLAB * cp.SLAB
    yx = cm.window_yx(by, bx, cp.SLAB, n)
    rows['slab'] = cm.run(
        'slab (K6 fused_kernel)', 'slab', f'{SCRIPT}:126',
        lambda: cp.slab(g9, fmap, by, bx),
        lambda: cp.slab_plain(g9, fmap, by, bx),
        cm.nbytes(g9, by, bx) + cm.map_bytes(None, *yx, 1, H4, W4) +
        E * P2 * n * 2, 2 * E * P2 * n * C, dev)
    return dict(E=E, variants=rows)


if __name__ == '__main__':
    cm.cli(main, __doc__)
