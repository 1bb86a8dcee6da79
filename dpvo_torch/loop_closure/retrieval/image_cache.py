"""Frame spill store for the classical loop-closure backend.

Keyframe-indexed full-resolution frames are needed again long after the VO
runtime has dropped them (keypoint matching when a retrieval hit fires, see
long_term.py). Keeping hundreds of 640x480 uint8 frames in RAM is wasteful,
so frames live in memory only while their index can still change under
keyframe compaction, then spill to JPEG files in a temp directory via a
single background worker process.

Copy of dpvo_tpu/loop_closure/retrieval/image_cache.py (host code, no
torch; copied so this package never imports the JAX package). It fulfils
the reference's image cache's role (dpvo/loop_closure/retrieval/
image_cache.py:15-72) with a pending-dict + single-slot write pipeline
behind an explicit spawn context (forking a multithreaded parent can
deadlock the child).
"""
from __future__ import annotations

import multiprocessing as mp
import os
from tempfile import TemporaryDirectory

import cv2
import numpy as np


def _encode_to(path, image, quality):
    return cv2.imwrite(path, image, [int(cv2.IMWRITE_JPEG_QUALITY), quality])


class ImageCache:
    """Spill store: ``cache(frame, n)`` buffers; ``save_up_to(c)`` spills
    every buffered frame with index <= c; ``load_frames(idxs)`` reads
    spilled frames back; ``keyframe(k)`` renumbers pending frames when the
    runtime removes keyframe k."""

    QUALITY = 95

    def __init__(self):
        self._pending = {}                    # idx -> HxWx3 uint8 (BGR)
        self._spilled = set()                 # indices already on disk
        self._dir = TemporaryDirectory(prefix='dpvo_imcache_')
        ctx = mp.get_context('spawn')
        self._worker = ctx.Pool(processes=1)
        # prime the worker (spawn interpreter start is ~1 s; do it now,
        # not on the first latency-sensitive spill)
        self._inflight = self._worker.apply_async(os.getpid, [])
        self._inflight.wait()

    # -- ingest -------------------------------------------------------- #

    def __call__(self, image, n):
        if not (isinstance(image, np.ndarray) and image.dtype == np.uint8
                and image.ndim == 3 and image.shape[2] == 3):
            raise TypeError('ImageCache expects HxWx3 uint8 frames')
        self._pending[n] = image

    def keyframe(self, k):
        """Keyframe k was removed: pending indices past k shift down by
        one, matching the runtime's frame compaction (frame k's own image
        is dropped — it can no longer be retrieved against)."""
        self._pending = {
            (n - 1 if n > k else n): img
            for n, img in self._pending.items() if n != k
        }

    # -- spill --------------------------------------------------------- #

    def _path(self, n):
        return os.path.join(self._dir.name, f'{n:08d}.jpeg')

    def save_up_to(self, c):
        """Spill every pending frame with index <= c. Past this point the
        runtime guarantees those indices are final (beyond the keyframe
        removal window)."""
        for n in sorted(i for i in self._pending if i <= c):
            if n in self._spilled:
                raise RuntimeError(f'frame {n} spilled twice — index '
                                   'compaction out of sync')
            img = self._pending.pop(n)
            self._inflight.wait()            # one write in flight at a time
            self._inflight = self._worker.apply_async(
                _encode_to, [self._path(n), img, self.QUALITY])
            self._spilled.add(n)

    # -- read back ----------------------------------------------------- #

    def load_frames(self, idxs):
        """List of HxWx3 uint8 BGR frames for spilled indices `idxs`."""
        self._inflight.wait()                # drain the write pipeline
        missing = [i for i in idxs if i not in self._spilled]
        if missing:
            raise KeyError(f'frames {missing} were never spilled')
        return [cv2.imread(self._path(i)) for i in idxs]

    def close(self):
        self._inflight.wait()
        self._worker.close()
        self._dir.cleanup()
