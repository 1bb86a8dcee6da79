"""The one generator of traffic: seeded inputs from a traffic mix's data.

A mix (traffic/<name>.json) gives the client count, the upload format,
the frame motion and the intrinsics; everything drawn is drawn from the
run's --seed. Every seed gets the same sizes and amounts of work: the seed
only changes the texture, the patch draws and the weights' values.
"""
from __future__ import annotations

import numpy as np


def seeds(seed, *path):
    """A 32-bit seed for one purpose of one run (`path`: a name and
    indices), from any whole --seed, negative or past 64 bits included."""
    words = [abs(int(seed)) >> (32 * i) & 0xFFFFFFFF for i in range(3)]
    words.append(int(seed) < 0)
    for p in path:
        words.extend(p.encode() if isinstance(p, str) else [int(p)])
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def render_ring(traffic, H, W, seed):
    """The mix's `ring` frames, (H, W, 3) uint8 each: a seeded smooth RGB
    texture seen through a crop that moves `dx` px right and `dy` px down
    per frame (the repository's chip_smoke.synthetic_frames, rendered
    once)."""
    from scipy.ndimage import gaussian_filter
    fr = traffic['frames']
    n, dx, dy = fr['ring'], fr['dx'], fr['dy']
    rng = np.random.RandomState(seed)
    tex = gaussian_filter(rng.rand(H + dy * n + 8, W + dx * n + 8, 3),
                          (fr['blur_sigma'], fr['blur_sigma'], 0))
    tex = (tex - tex.min()) / np.ptp(tex) * 255.0
    return [np.ascontiguousarray(tex[dy * t:dy * t + H, dx * t:dx * t + W]
                                 .astype(np.uint8)) for t in range(n)]


def ring_index(t, n):
    """Position of sequence frame t in a ring of n rendered frames: the
    crop runs forward over the ring, then back, so any length of sequence
    needs no rendering while it runs."""
    p = t % (2 * n - 2)
    return p if p < n else 2 * n - 2 - p


def cycle(traffic):
    """Frames in one pass of the ring, forward and back: the sequence's
    period. The keyframe decisions, and with them the live edges, follow
    the motion's phase, so a stretch of frames that stands for the whole
    sequence covers whole passes."""
    return 2 * traffic['frames']['ring'] - 2


class Sequence:
    """One client's frames: frame(t) for any t >= 0, and the intrinsics."""

    def __init__(self, traffic, H, W, seed):
        self.ring = render_ring(traffic, H, W, seed)
        self.intrinsics = np.asarray(traffic['intrinsics'], np.float32)

    def frame(self, t):
        return self.ring[ring_index(t, len(self.ring))]


def patch_draws(seed, M, h4, w4, count):
    """The host draws DeviceVO makes from np.random.RandomState(seed) for
    its first `count` frames with CENTROID_SEL_STRAT RANDOM, in its order
    (per frame: M x, M y in [1, dim - 1), then M depth seeds): (count, M,
    2) f32 centroids at 1/4 scale and (count, M) f64 seeds. The reference
    makes them itself; the program draws its own."""
    rng = np.random.RandomState(seed)
    coords = np.empty((count, M, 2), np.float32)
    depth = np.empty((count, M))
    for t in range(count):
        x = rng.randint(1, w4 - 1, M)
        y = rng.randint(1, h4 - 1, M)
        coords[t] = np.stack([x, y], axis=-1)
        depth[t] = rng.rand(M)
    return coords, depth
