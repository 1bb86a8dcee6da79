"""Loop-candidate retrieval service over the native BoW backend.

Copy of dpvo_tpu/loop_closure/retrieval/retrieval_native.py (host code, no
torch) over this package's own build of the library. It mirrors the
reference RetrievalDBOW wrapper (dpvo/loop_closure/retrieval/
retrieval_dbow.py:28-125): a dedicated process runs ORB + bag-of-words
insert/query over a queue; the main loop buffers frames keyed by
keyframe-compacted indices, detects loops with a score threshold, NMS
against previous closures, and a consecutive-hit requirement.

The backend is dpvo_torch/native/dpretrieval.cpp (vocabulary-free tf-idf
BoW, dpvo_tpu's with its OpenCV half moved here) instead of DBoW2 + a
downloaded ORB vocabulary. ORB detection (cv2.ORB_create(750, 1.09, 14),
the detector dpvo_tpu's library runs in C++; the same keypoints and
descriptors, bit for bit) and the cross-checked Hamming matching
(cv2.BFMatcher) run in Python, so a cv2 wheel without OpenCV's C++
headers or libraries is enough. library_path() compiles the library with
plain g++ on first use into build/dpvo_torch_native/libdpretrieval_<hash>.so
(one library per hash of the source and the flags), renamed into place
atomically so that concurrent processes agree on one file; a failed build
raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import multiprocessing as _mp
from pathlib import Path

# spawn, not fork: the parent is multithreaded and fork can deadlock the
# child (the reference relies on mp.set_start_method('spawn'),
# dpvo/dpvo.py:13; this module scopes it instead of setting it globally)
_ctx = _mp.get_context('spawn')
Process, Queue, Value = _ctx.Process, _ctx.Queue, _ctx.Value

import numpy as np

NMS = 50   # reference retrieval_dbow.py:14
RAD = 50

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'dpretrieval.cpp'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'dpvo_torch_native'


FLAGS = ['-O2', '-shared', '-fPIC', '-std=c++17']


def library_path():
    """The built library, compiled first if this hash of the source and
    flags has none yet."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(' '.join(FLAGS).encode())
    so = BUILD_DIR / f'libdpretrieval_{h.hexdigest()[:12]}.so'
    if so.exists():
        return so
    if not shutil.which('g++'):
        raise RuntimeError('the native retrieval library needs g++ to build '
                           f'{SOURCE}')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    proc = subprocess.run(['g++', *FLAGS, str(SOURCE), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f'building the native retrieval library failed '
            f'({proc.returncode}):\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, so)
    return so


def _load_lib(path=None):
    lib = ctypes.CDLL(str(path or library_path()))
    lib.dpr_create.restype = ctypes.c_void_p
    lib.dpr_create.argtypes = [ctypes.c_int]
    lib.dpr_insert_features.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
    lib.dpr_query.argtypes = [ctypes.c_void_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(ctypes.c_int)]
    return lib


class NativeRetrieval:
    """Thin in-process wrapper (same API as the reference pybind class):
    ORB and matching on cv2, the BoW database in the library. Raises
    ImportError without cv2."""

    def __init__(self, rad=RAD, path=None):
        try:
            import cv2
        except ImportError as e:
            raise ImportError('the retrieval backend needs OpenCV, whose '
                              f'cv2 module is missing: {e}') from e
        self._cv2 = cv2
        # finer scale pyramid than ORB's default (1.2^8): under moderate
        # zoom a keypoint re-detects closer to its original octave, keeping
        # the BRIEF pattern footprint, and hence the hashed words, stable
        self._orb = cv2.ORB_create(nfeatures=750, scaleFactor=1.09,
                                   nlevels=14)
        self._lib = _load_lib(path)
        self._h = self._lib.dpr_create(rad)
        self._feats = []          # per image: (keypoints (n, 2), descs)

    def insert_image(self, image):
        image = np.ascontiguousarray(image, np.uint8)
        kps, descs = self._orb.detectAndCompute(image, None)
        pts = np.array([kp.pt for kp in kps], np.float32).reshape(-1, 2)
        descs = (np.zeros((0, 32), np.uint8) if descs is None else
                 np.ascontiguousarray(descs, np.uint8))
        self._feats.append((pts, descs))
        self._lib.dpr_insert_features(
            self._h, descs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(descs))

    def query(self, i):
        score = ctypes.c_float()
        j = ctypes.c_int()
        self._lib.dpr_query(self._h, i, ctypes.byref(score), ctypes.byref(j))
        return float(score.value), int(j.value), None

    def match_pair(self, ti, qi, cap=2048):
        """Cross-checked Hamming matches of image qi's descriptors against
        image ti's, in query order: rows (tx, ty, qx, qy, distance), at
        most cap."""
        n = len(self._feats)
        if not (0 <= ti < n and 0 <= qi < n):
            return np.zeros((0, 5), np.float64)
        (tp, td), (qp, qd) = self._feats[ti], self._feats[qi]
        if len(td) == 0 or len(qd) == 0:
            return np.zeros((0, 5), np.float64)
        matcher = self._cv2.BFMatcher(self._cv2.NORM_HAMMING, crossCheck=True)
        m = matcher.match(qd, td)[:cap]
        t = np.array([x.trainIdx for x in m], np.int64)
        q = np.array([x.queryIdx for x in m], np.int64)
        d = np.array([x.distance for x in m], np.float64)
        return np.concatenate([tp[t], qp[q], d[:, None]], axis=1,
                              dtype=np.float64).reshape(-1, 5)


def _retrieval_loop(in_queue, out_queue, rad, ready, path):
    db = NativeRetrieval(rad, path)
    ready.value = 1
    while True:
        msg = in_queue.get()
        if msg is None:
            break
        # frames arrive in ascending keyframe-compacted order, so the db
        # insertion index equals n (same invariant as the reference,
        # retrieval_dbow.py:66-71)
        _, n, image = msg
        db.insert_image(image)
        out_queue.put((n, db.query(n)))


class RetrievalDBOW:
    """Process-hosted retrieval with the reference's exact bookkeeping."""

    def __init__(self, rad=RAD):
        path = library_path()   # builds it, or raises with g++'s output

        self.image_buffer = {}
        self.stored_indices = np.zeros(100000, dtype=bool)
        self.prev_loop_closes = []
        self.found = []

        self.in_queue = Queue(maxsize=20)
        self.out_queue = Queue(maxsize=20)
        # never block interpreter exit on the queue feeder threads: if the
        # worker died (or a test failed mid-run), unsent items would hang
        # mp.util._exit_function joining the feeder forever
        self.in_queue.cancel_join_thread()
        self.out_queue.cancel_join_thread()
        ready = Value('i', 0)
        self.proc = Process(target=_retrieval_loop,
                            args=(self.in_queue, self.out_queue, rad, ready,
                                  str(path)),
                            daemon=True)
        self.proc.start()
        self.being_processed = 0
        while not ready.value:
            if not self.proc.is_alive():
                raise RuntimeError(f'the retrieval process exited with '
                                   f'{self.proc.exitcode} before it was ready')
            time.sleep(0.01)

    def keyframe(self, k):
        """Keyframe-compacted index shift (retrieval_dbow.py:54-63)."""
        tmp = dict(self.image_buffer)
        self.image_buffer.clear()
        for n, v in tmp.items():
            if n != k:
                key = (n - 1) if (n > k) else n
                self.image_buffer[key] = v

    def save_up_to(self, c):
        for n in list(self.image_buffer):
            if n <= c:
                assert not self.stored_indices[n]
                img = self.image_buffer.pop(n)
                self.in_queue.put(('insert', n, img))
                self.stored_indices[n] = True
                self.being_processed += 1

    def confirm_loop(self, i, j):
        assert i > j
        self.prev_loop_closes.append((i, j))

    def _repetition_check(self, idx, num_repeat):
        """Require num_repeat consecutive hits; return the middle one
        (reference retrieval_dbow.py:79-87 unpacks the triplet's middle)."""
        if len(self.found) < num_repeat:
            return None
        latest = self.found[-num_repeat:]
        b = latest[0][0]
        i, j = latest[len(latest) // 2]
        if (1 + idx - b) == num_repeat:
            return (i, max(j, 1))
        return None

    def _detect_loop(self, thresh, num_repeat=1):
        assert self.being_processed > 0
        i, (score, j, _) = self.out_queue.get()
        self.being_processed -= 1
        if score < thresh or j < 0:
            return None
        assert i > j, (i, j)

        dists_sq = [np.square(i - a) + np.square(j - b)
                    for a, b in self.prev_loop_closes]
        if min(dists_sq, default=np.inf) < np.square(NMS):
            return None

        self.found.append((i, j))
        return self._repetition_check(i, num_repeat)

    def detect_loop(self, thresh, num_repeat=1):
        while self.being_processed > 0:
            x = self._detect_loop(thresh, num_repeat)
            if x is not None:
                return x
        return None

    def __call__(self, image, n):
        assert isinstance(image, np.ndarray) and image.dtype == np.uint8
        assert image.ndim == 3 and image.shape[2] == 3
        self.image_buffer[n] = image

    def close(self):
        self.proc.terminate()
        self.proc.join()
        self.in_queue.close()
        self.out_queue.close()
