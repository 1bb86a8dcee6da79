"""Host-side I420 packing for the camera-native upload (UPLOAD_FORMAT=yuv420).

dpvo_tpu packs frames with cv2.cvtColor(..., cv2.COLOR_RGB2YUV_I420); a GPU
host need not have OpenCV, so this is the same conversion in numpy,
bit-exact with cv2 (tests/test_torch_ingest.py): video-range BT.601 in
20-bit fixed point with round-half-up, the chroma of each 2x2 block taken
from its top-left pixel. Every sum stays below 2^28, so int32 holds it. The
device turns the planes back into RGB with device_vo.i420_to_rgb.
"""
from __future__ import annotations

import numpy as np

_S = 20
_HALF = 1 << (_S - 1)


def rgb_to_i420(image):
    """(H, W, 3) uint8 RGB with even H, W -> (3H/2, W) uint8 I420 planes:
    Y (H, W), then U and V (H/2, W/2 each) stored row-major one after the
    other, as cv2.COLOR_RGB2YUV_I420 lays them out."""
    image = np.asarray(image, np.uint8)
    H, W, _ = image.shape
    if H % 2 or W % 2:
        raise ValueError(f'I420 needs even dims, got {H}x{W}')
    r, g, b = (image[..., c].astype(np.int32) for c in range(3))
    out = np.empty((H * 3 // 2, W), np.uint8)
    flat = out.reshape(-1)
    n, q = H * W, H * W // 4
    y = r * 269484
    y += g * 528482
    y += b * 102760
    y += (16 << _S) + _HALF
    y >>= _S
    flat[:n] = y.reshape(-1)
    r, g, b = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    u = b * 460324
    u -= r * 155188
    u -= g * 305135
    u += (128 << _S) + _HALF
    u >>= _S
    flat[n:n + q] = u.reshape(-1)
    v = r * 460324
    v -= g * 385875
    v -= b * 74448
    v += (128 << _S) + _HALF
    v >>= _S
    flat[n + q:] = v.reshape(-1)
    return out
