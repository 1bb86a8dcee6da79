"""Frame readers feeding a multiprocessing queue.

Copy of dpvo_tpu/stream.py (numpy, cv2 and the standard library). Mirrors
the reference dpvo/stream.py:8-89: directory-of-images or video streams,
calibration text files (fx fy cx cy [+distortion]), undistortion, crop to
a multiple of 16, sentinel (-1, image, intrinsics) to stop.
"""
from __future__ import annotations

from itertools import chain
from pathlib import Path

import cv2
import numpy as np


def load_calib(calib_path):
    calib = np.loadtxt(calib_path, delimiter=' ')
    fx, fy, cx, cy = calib[:4]
    K = np.eye(3)
    K[0, 0] = fx
    K[0, 2] = cx
    K[1, 1] = fy
    K[1, 2] = cy
    return calib, K


def image_stream(queue, imagedir, calib, stride, skip=0):
    """Feed (t, image, intrinsics) tuples from a directory of images."""
    calib, K = load_calib(calib)
    img_exts = ['*.png', '*.jpeg', '*.jpg']
    image_list = sorted(chain.from_iterable(
        Path(imagedir).glob(e) for e in img_exts))[skip::stride]

    for t, imfile in enumerate(image_list):
        image = cv2.imread(str(imfile))
        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        intrinsics = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]

        queue.put((t, image, intrinsics))

    queue.put((-1, image, intrinsics))


def video_stream(queue, imagedir, calib, stride, skip=0):
    """Feed (t, image, intrinsics) tuples from a video file."""
    calib, K = load_calib(calib)
    cap = cv2.VideoCapture(imagedir)
    t = 0
    for _ in range(skip):
        ret, image = cap.read()

    while True:
        for _ in range(stride):
            ret, image = cap.read()
            if not ret:
                break
        if not ret:
            break

        if len(calib) > 4:
            image = cv2.undistort(image, K, calib[4:])

        image = cv2.resize(image, None, fx=0.5, fy=0.5)
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]

        intrinsics = np.array([K[0, 0] / 2, K[1, 1] / 2,
                               K[0, 2] / 2, K[1, 2] / 2])
        queue.put((t, image, intrinsics))
        t += 1

    queue.put((-1, image, intrinsics))
    cap.release()
