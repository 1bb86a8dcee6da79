"""Patch centroid selection (reference net.py:119-136), host-side.

Same function as dpvo_tpu/runtime/centroid.py (pure numpy; copied so this
package never imports the JAX package).

RANDOM draws M quarter-res coordinates; GRADIENT_BIAS draws 3M candidates
and keeps the top M by the 4x4-block-pooled image gradient magnitude.
The scoring touches ONLY the 3M candidate blocks (5x5 full-res windows)
instead of filtering the whole frame: numerically identical scores to the
full-image pooled-gradient formulation at a fraction of the work — this
runs on the per-frame critical path.
"""
from __future__ import annotations

import numpy as np

_OFF5 = np.arange(5)


def select_coords(cfg, rng, image, M, h4, w4):
    """(M, 2) float32 quarter-res patch centroids for one frame."""
    if cfg.CENTROID_SEL_STRAT != 'GRADIENT_BIAS':
        x = rng.randint(1, w4 - 1, M)
        y = rng.randint(1, h4 - 1, M)
        return np.stack([x, y], axis=-1).astype(np.float32)

    x = rng.randint(1, w4 - 1, 3 * M)
    y = rng.randint(1, h4 - 1, 3 * M)
    # 5x5 full-res windows at each candidate block (4y..4y+4 x 4x..4x+4):
    # enough rows/cols for the 4x4 grid of forward-difference gradients
    # the block-mean pools over. Candidates are in [1, dim-1), so the +4
    # reach stays in bounds.
    rows = 4 * y[:, None, None] + _OFF5[None, :, None]    # (3M, 5, 1)
    cols = 4 * x[:, None, None] + _OFF5[None, None, :]    # (3M, 1, 5)
    win = image[rows, cols].sum(axis=-1, dtype=np.float32)  # (3M, 5, 5)
    dx = win[:, :4, 1:5] - win[:, :4, :4]
    dy = win[:, 1:5, :4] - win[:, :4, :4]
    score = np.sqrt(dx * dx + dy * dy).mean(axis=(1, 2))
    top = np.argsort(score)[-M:]
    return np.stack([x[top], y[top]], -1).astype(np.float32)
