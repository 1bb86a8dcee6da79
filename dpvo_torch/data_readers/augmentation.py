"""RGB-D video augmentation (NumPy/cv2, torchvision-free).

Copy of dpvo_tpu/data_readers/augmentation.py, which mirrors reference
dpvo/data_readers/augmentation.py:7-66: color jitter / random grayscale /
random invert on the whole clip, random up-scale (2^U(0, 0.5) with p=0.8)
+ center crop with intrinsics adjustment. It draws from the generator it
is given (a np.random.RandomState, or a seed for one), where dpvo_tpu's
draws from an unseeded RandomState; with the same generator state both
give the same clip.
"""
from __future__ import annotations

import cv2
import numpy as np


class RGBDAugmentor:
    def __init__(self, crop_size, rng=0):
        self.crop_size = tuple(crop_size)
        self.max_scale = 0.5
        self.rng = (rng if isinstance(rng, np.random.RandomState) else
                    np.random.RandomState(rng))

    # -------------------------------------------------------------- #
    def color_transform(self, images):
        """brightness/contrast/saturation/hue jitter + grayscale/invert."""
        rng = self.rng
        b = rng.uniform(max(0, 1 - 0.4), 1 + 0.4)
        c = rng.uniform(max(0, 1 - 0.4), 1 + 0.4)
        s = rng.uniform(max(0, 1 - 0.4), 1 + 0.4)
        h = rng.uniform(-0.2 / 3.14, 0.2 / 3.14)

        out = images * b                                     # brightness
        mean = out.mean(axis=(-3, -2, -1), keepdims=True)
        out = (out - mean) * c + mean                        # contrast
        gray = out.mean(axis=-1, keepdims=True)
        out = (out - gray) * s + gray                        # saturation
        # hue: rotate channels in HSV space
        out8 = np.clip(out, 0, 255).astype(np.uint8)
        for t in range(out8.shape[0]):
            hsv = cv2.cvtColor(out8[t], cv2.COLOR_BGR2HSV).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(h * 180)) % 180
            out8[t] = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
        out = out8.astype(np.float32)

        if rng.rand() < 0.1:                                 # grayscale
            out = np.repeat(out.mean(axis=-1, keepdims=True), 3, axis=-1)
        if rng.rand() < 0.1:                                 # invert
            out = 255.0 - out
        return out

    def spatial_transform(self, images, poses, disps, intrinsics):
        T, ht, wd, _ = images.shape
        scale = 1.0
        if self.rng.rand() < 0.8:
            scale = 2 ** self.rng.uniform(0.0, self.max_scale)
        min_scale = max((self.crop_size[0] + 1) / ht,
                        (self.crop_size[1] + 1) / wd)
        scale = max(scale, min_scale)

        ht1, wd1 = int(scale * ht), int(scale * wd)
        intrinsics = intrinsics * scale

        imgs, dsp = [], []
        for t in range(T):
            imgs.append(cv2.resize(images[t], (wd1, ht1),
                                   interpolation=cv2.INTER_CUBIC))
            dsp.append(cv2.resize(disps[t], (wd1, ht1),
                                  interpolation=cv2.INTER_NEAREST))
        images = np.stack(imgs)
        disps = np.stack(dsp)

        y0 = (ht1 - self.crop_size[0]) // 2
        x0 = (wd1 - self.crop_size[1]) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0])
        images = images[:, y0:y0 + self.crop_size[0],
                        x0:x0 + self.crop_size[1]]
        disps = disps[:, y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return images, poses, disps, intrinsics

    def __call__(self, images, poses, disps, intrinsics):
        if self.rng.rand() < 0.5:
            images = self.color_transform(images)
        return self.spatial_transform(images, poses, disps, intrinsics)
