"""Flow / depth file readers (reference dpvo/data_readers/frame_utils.py).

Copy of dpvo_tpu/data_readers/frame_utils.py (numpy + cv2): readers for
.flo (Middlebury), .pfm, KITTI 16-bit flow and disparity PNGs, and generic
image/depth files, the .flo writer, plus writers of .pfm and KITTI flow
PNGs (the reference's writeFlowKITTI) that dpvo_tpu's readers read back.
Not on the main training path (the reference marks them the same way) but
part of the public surface.
"""
from __future__ import annotations

import re

import cv2
import numpy as np

TAG_CHAR = np.array([202021.25], np.float32)


def readFlow(fn):
    """Read a .flo file (Middlebury format)."""
    with open(fn, 'rb') as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic != 202021.25:
            raise ValueError(f'Invalid .flo magic in {fn}')
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return np.resize(data, (h, w, 2))


def writeFlow(fn, uv, v=None):
    if v is None:
        assert uv.ndim == 3 and uv.shape[2] == 2
        u, v = uv[:, :, 0], uv[:, :, 1]
    else:
        u = uv
    h, w = u.shape
    with open(fn, 'wb') as f:
        TAG_CHAR.tofile(f)
        np.array(w, np.int32).tofile(f)
        np.array(h, np.int32).tofile(f)
        tmp = np.zeros((h, w * 2), np.float32)
        tmp[:, ::2] = u
        tmp[:, 1::2] = v
        tmp.tofile(f)


def readPFM(file):
    with open(file, 'rb') as f:
        header = f.readline().rstrip()
        color = header == b'PF'
        if header not in (b'PF', b'Pf'):
            raise ValueError('Not a PFM file.')
        dims = re.match(rb'^(\d+)\s(\d+)\s$', f.readline())
        if not dims:
            raise ValueError('Malformed PFM header.')
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = '<' if scale < 0 else '>'
        data = np.fromfile(f, endian + 'f')
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape))


def writePFM(file, image, scale=1):
    """Write a (H, W) or (H, W, 3) float32 .pfm, little-endian, rows
    bottom to top (readPFM's inverse)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b'PF'
    elif image.ndim == 2:
        header = b'Pf'
    else:
        raise ValueError('PFM holds (H, W) or (H, W, 3) images')
    with open(file, 'wb') as f:
        f.write(header + b'\n')
        f.write(b'%d %d\n' % (image.shape[1], image.shape[0]))
        f.write(b'%r\n' % float(-abs(scale)))
        np.ascontiguousarray(np.flipud(image), '<f4').tofile(f)


def writeFlowKITTI(filename, uv):
    """Write flow (H, W, 2) as a KITTI 16-bit PNG: 64 x flow + 2^15 in the
    first two channels, valid = 1 in the third (readFlowKITTI's
    inverse)."""
    uv = 64.0 * np.asarray(uv, np.float64) + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(filename, uv[..., ::-1])


def readFlowKITTI(filename):
    flow = cv2.imread(filename, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    flow = flow[:, :, ::-1].astype(np.float32)
    flow, valid = flow[:, :, :2], flow[:, :, 2]
    flow = (flow - 2 ** 15) / 64.0
    return flow, valid


def readDispKITTI(filename):
    disp = cv2.imread(filename, cv2.IMREAD_ANYDEPTH) / 256.0
    valid = disp > 0.0
    return disp, valid


def read_gen(file_name, pil=False):
    ext = file_name.split('.')[-1].lower()
    if ext in ('png', 'jpeg', 'ppm', 'jpg'):
        return cv2.imread(file_name)
    if ext == 'flo':
        return readFlow(file_name).astype(np.float32)
    if ext == 'pfm':
        flow = readPFM(file_name).astype(np.float32)
        return flow if len(flow.shape) == 2 else flow[:, :, :-1]
    return []
