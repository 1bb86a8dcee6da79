"""Synthetic photometric scenes with exact ground truth.

Copy of dpvo_tpu/data_readers/synthetic.py (numpy only; copied so this
package never imports the JAX package; the same seed gives the same
arrays, bit for bit). Renders a textured slanted plane (closed-form ray
intersection, so images, inverse depth and poses are mutually exact)
under a smooth random camera trajectory, forward or out-and-back: the
accuracy gates' sequences (dpvo_torch/accuracy.py), stacked by
make_batch_from / make_batch the trainer's batches, and as the Synthetic
dataset train/cli.py's --dataset synthetic.
"""
from __future__ import annotations

import numpy as np

from ..runtime import numpy_se3 as nse3


def _smooth_noise(rng, shape, sigma):
    """Separable box-blurred noise (no scipy dependency)."""
    x = rng.randn(*shape).astype(np.float32)
    k = max(int(sigma) | 1, 3)
    ker = np.hanning(k + 2)[1:-1]
    ker /= ker.sum()
    for ax in range(len(shape)):
        x = np.apply_along_axis(
            lambda v: np.convolve(v, ker, mode='same'), ax, x)
    return x


def make_texture(rng, size=1024):
    """High-contrast multi-scale texture (RGB uint8)."""
    acc = np.zeros((size, size), np.float32)
    for sigma, amp in ((2, 1.0), (8, 1.0), (32, 1.0)):
        acc += amp * _smooth_noise(rng, (size, size), sigma)
    acc = (acc - acc.min()) / (acc.max() - acc.min() + 1e-9)
    rgb = np.stack([acc,
                    np.roll(acc, size // 3, 0),
                    np.roll(acc, size // 3, 1)], -1)
    return (rgb * 255).astype(np.uint8)


def make_trajectory(rng, T, step=0.12, z0=3.5):
    """Smooth world-from-camera trajectory looking down +z at the plane.

    Forward motion in x with wobble in y/z and small rotations — the
    sideways-translation + weak-rotation regime VO operates in.
    Returns (T, 7) x y z qx qy qz qw (world-from-cam).
    """
    t = np.arange(T, dtype=np.float32)
    pos = np.stack([
        step * t + 0.03 * np.sin(0.9 * t + rng.rand() * 6),
        0.08 * np.sin(0.5 * t + rng.rand() * 6),
        0.06 * np.sin(0.33 * t + rng.rand() * 6),
    ], -1).astype(np.float32)
    yaw = 0.04 * np.sin(0.4 * t + rng.rand() * 6)
    pit = 0.03 * np.sin(0.27 * t + rng.rand() * 6)
    wfc = np.zeros((T, 7), np.float32)
    wfc[:, :3] = pos
    # small-angle quaternion from yaw (about y) then pitch (about x)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pit / 2), np.sin(pit / 2)
    # q = qy * qx  (w-last)
    wfc[:, 3] = cy * sp
    wfc[:, 4] = sy * cp
    wfc[:, 5] = -sy * sp
    wfc[:, 6] = cy * cp
    q = wfc[:, 3:7]
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    del z0
    return wfc


def make_loop_trajectory(rng, T, step=0.12):
    """Out-and-back trajectory: x advances for T/2 frames then returns
    along (nearly) the same line, so late frames REVISIT early viewpoints —
    the regime DPV-SLAM's proximity loop closure exists for (reference
    patchgraph.py:56-82). Small lateral offset + wobble keep frames
    distinct. Returns (T, 7) world-from-cam xyzquat."""
    t = np.arange(T, dtype=np.float32)
    half = T / 2.0
    x = step * np.where(t <= half, t, T - t).astype(np.float32)
    pos = np.stack([
        x + 0.02 * np.sin(0.9 * t + rng.rand() * 6),
        0.05 * np.sin(0.5 * t + rng.rand() * 6) + 0.04 * (t > half),
        0.04 * np.sin(0.33 * t + rng.rand() * 6),
    ], -1).astype(np.float32)
    yaw = 0.03 * np.sin(0.4 * t + rng.rand() * 6)
    pit = 0.02 * np.sin(0.27 * t + rng.rand() * 6)
    wfc = np.zeros((T, 7), np.float32)
    wfc[:, :3] = pos
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pit / 2), np.sin(pit / 2)
    wfc[:, 3] = cy * sp
    wfc[:, 4] = sy * cp
    wfc[:, 5] = -sy * sp
    wfc[:, 6] = cy * cp
    wfc[:, 3:7] /= np.linalg.norm(wfc[:, 3:7], axis=-1, keepdims=True)
    return wfc


def _quat_mat(q):
    """(…,4) xyzw -> (…,3,3) rotation matrices."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1),
    ], -2)


def render_plane_view(tex, wfc, intr, H, W, plane_n, plane_c,
                      tex_scale=180.0):
    """Render one view of the textured plane n.X = c.

    wfc: (7,) world-from-camera. Returns (image u8 (H,W,3), z-depth (H,W)).
    """
    fx, fy, cx, cy = intr
    u, v = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5)
    d_c = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    R = _quat_mat(wfc[3:7])
    o = wfc[:3]
    d_w = d_c @ R.T
    denom = d_w @ plane_n
    lam = (plane_c - o @ plane_n) / np.maximum(denom, 1e-6)
    X_w = o[None, None] + lam[..., None] * d_w

    th, tw = tex.shape[:2]
    s = X_w[..., 0] * tex_scale + tw / 2
    t = X_w[..., 1] * tex_scale + th / 2
    s = np.clip(s, 0, tw - 2)
    t = np.clip(t, 0, th - 2)
    s0, t0 = s.astype(np.int32), t.astype(np.int32)
    fs, ft = (s - s0)[..., None], (t - t0)[..., None]
    texf = tex.astype(np.float32)
    img = ((1 - ft) * ((1 - fs) * texf[t0, s0] + fs * texf[t0, s0 + 1]) +
           ft * ((1 - fs) * texf[t0 + 1, s0] + fs * texf[t0 + 1, s0 + 1]))
    return img.astype(np.uint8), lam  # z-depth == lam (d_c.z == 1)


def make_sequence(seed, T=15, H=64, W=96, step=0.12, loop=False):
    """One evaluation sequence with exact GT (dpvo_tpu's make_sequence):
    the forward trajectory, or with loop=True the out-and-back revisit
    trajectory (make_loop_trajectory) for loop-closure certification.
    Returns dict: images (T,H,W,3) u8, poses_w2c (T,7), disps4
    (T,H//4,W//4) inverse z-depth at feature res, intrinsics (4,) full-res.
    """
    rng = np.random.RandomState(seed)
    tex = make_texture(rng)
    # slanted plane: z = z0 + a x + b y  ->  n=(-a,-b,1), c = z0
    a, b = rng.uniform(-0.25, 0.25, 2)
    z0 = rng.uniform(3.0, 4.0)
    n = np.array([-a, -b, 1.0], np.float32)
    intr = np.array([0.9 * W, 0.9 * W, W / 2, H / 2], np.float32)
    if loop:
        wfc = make_loop_trajectory(rng, T, step=step)
    else:
        wfc = make_trajectory(rng, T, step=step, z0=z0)

    H4, W4 = H // 4, W // 4
    intr4 = intr / 4.0
    images = np.zeros((T, H, W, 3), np.uint8)
    disps4 = np.zeros((T, H4, W4), np.float32)
    for t in range(T):
        images[t], _ = render_plane_view(tex, wfc[t], intr, H, W, n, z0)
        _, z4 = render_plane_view(tex, wfc[t], intr4, H4, W4, n, z0)
        disps4[t] = 1.0 / np.maximum(z4, 0.2)

    poses_w2c = nse3.inv(wfc)
    return dict(images=images, poses_w2c=poses_w2c.astype(np.float32),
                disps4=disps4, intrinsics=intr, wfc=wfc)


def make_batch_from(seqs, rng, M):
    """Stack pre-rendered sequences into the trainer's batch dict
    (train/trainer.py:make_train_step) with fresh patch coords and depth
    seeds from the numpy RandomState rng."""
    B = len(seqs)
    T = seqs[0]['images'].shape[0]
    H4 = seqs[0]['images'].shape[1] // 4
    W4 = seqs[0]['images'].shape[2] // 4
    coords = np.stack([rng.randint(1, W4 - 1, (B, T, M)),
                       rng.randint(1, H4 - 1, (B, T, M))],
                      -1).astype(np.float32)
    return dict(
        images=np.stack([s['images'] for s in seqs]).astype(np.float32),
        poses_gt=np.stack([s['poses_w2c'] for s in seqs]),
        disps=np.stack([s['disps4'] for s in seqs]),
        intrinsics=np.stack([s['intrinsics'] for s in seqs]),
        coords=coords,
        depth_init=rng.uniform(0.2, 0.6, (B, T, M)).astype(np.float32),
    )


def make_batch(seeds, T=15, M=8, H=64, W=96, step=0.12):
    """Render + stack (convenience wrapper over make_batch_from)."""
    seqs = [make_sequence(s, T=T, H=H, W=W, step=step) for s in seeds]
    rng = np.random.RandomState(seeds[0] * 7919 + 13)
    return make_batch_from(seqs, rng, M)


class Synthetic:
    """Dataset-protocol wrapper over the renderer for train/cli.py
    (dpvo_tpu's Synthetic, the same renders). Item contract matches
    TartanAir's (data_readers/tartan.py): (images (T, H, W, 3) u8, poses
    world-from-cam (T, 7), disps FULL-res (T, H, W), intrinsics (T, 4)).
    Scenes render lazily and cache."""

    def __init__(self, n_scenes=64, n_frames=15, H=240, W=320, seed0=5000,
                 step=0.12, **_):
        self.n_scenes = n_scenes
        self.T, self.H, self.W = n_frames, H, W
        self.seed0, self.step = seed0, step
        self._cache = {}

    def __len__(self):
        return self.n_scenes

    def __getitem__(self, i):
        i = int(i) % self.n_scenes
        if i not in self._cache:
            rng = np.random.RandomState(self.seed0 + i)
            tex = make_texture(rng)
            a, b = rng.uniform(-0.25, 0.25, 2)
            z0 = rng.uniform(3.0, 4.0)
            n = np.array([-a, -b, 1.0], np.float32)
            intr = np.array([0.9 * self.W, 0.9 * self.W,
                             self.W / 2, self.H / 2], np.float32)
            wfc = make_trajectory(rng, self.T, step=self.step, z0=z0)
            images = np.zeros((self.T, self.H, self.W, 3), np.uint8)
            disps = np.zeros((self.T, self.H, self.W), np.float32)
            for t in range(self.T):
                images[t], z = render_plane_view(tex, wfc[t], intr,
                                                 self.H, self.W, n, z0)
                disps[t] = 1.0 / np.maximum(z, 0.2)
            self._cache[i] = (images, wfc.copy(), disps,
                              np.tile(intr, (self.T, 1)))
        return self._cache[i]
