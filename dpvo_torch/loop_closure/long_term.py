"""Classical long-term loop closure (DPV-SLAM backend #2).

Port of dpvo_tpu/loop_closure/long_term.py, which mirrors the reference
LongTermLoopClosure (dpvo/loop_closure/long_term.py:20-267): BoW retrieval
+ JPEG image cache feed loop candidates; keypoint triplets are triangulated
with a structure-only BA on the runtime's device; the Sim3 between the two
local point clouds is estimated with RANSAC-Umeyama; a Sim3 pose-graph
optimization runs asynchronously in a worker process on the CPU
(loop_closure/pgo.py), whose apply_pgo_result writes its result into the
live state with depth / delta rescaling and a gauge normalization.

Substitutions vs the reference, as in dpvo_tpu:
  * DISK+LightGlue keypoints -> OpenCV ORB + cross-checked Hamming matching;
  * DBoW2 vocabulary retrieval -> self-contained tf-idf BoW (native C++,
    built by retrieval/retrieval_native.py).

OpenCV is required: without it importing this module raises ImportError
and the runtime refuses CLASSIC_LOOP_CLOSURE (no silent pure-VO run). The
RANSAC draws come from `self.rng`, seeded from the runtime's seed, so a
run closes its loops with the same Sim3s every time.
"""
from __future__ import annotations

import multiprocessing as mp

try:
    import cv2
except ImportError as e:
    raise ImportError('classic loop closure (CLASSIC_LOOP_CLOSURE) needs '
                      f'OpenCV, whose cv2 module is missing: {e}') from e
import numpy as np
import torch

from .. import ba as ba_mod
from ..runtime import numpy_se3 as nse3
from .optim import make_sim3, ransac_umeyama
from .pgo import apply_pgo_result, run_DPVO_PGO, se3_to_sim3
from .retrieval import ImageCache, RetrievalDBOW

MIN_NUM_INLIERS = 30


def triangulate(poses3, xy, depth, intr, target, *, device):
    """The triplet's structure-only BA (reference long_term.py:120-138), 6
    steps: n patches at xy (n, 2) in the middle frame of poses3 (3, 7),
    seen at target (2n, 2) in frames 0 and 2 (the first n rows frame 0),
    unit weights, depths from depth (n,); returns the (n,) optimized depths
    as numpy. Runs on `device`; only the depths come back."""
    n = len(xy)
    dev = torch.device(device)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    kk = np.tile(np.arange(n), 2)
    ii = np.ones(2 * n, np.int64)
    jj = np.zeros(2 * n, np.int64)
    jj[n:] = 2
    _, depth_opt = ba_mod.bundle_adjust(
        t(poses3), t(xy), t(depth), t(intr), t(target),
        torch.ones((2 * n, 2), device=dev), 1e-3, t(ii, torch.long),
        t(jj, torch.long), t(kk, torch.long),
        torch.ones(2 * n, dtype=torch.bool, device=dev), 3, 3, 0,
        W=4, PC=n, iterations=6, structure_only=True)
    return depth_opt.cpu().numpy()


class LongTermLoopClosure:

    def __init__(self, cfg, slam, seed):
        self.cfg = cfg
        self.slam = slam
        self.rng = np.random.RandomState(seed)

        self.retrieval = RetrievalDBOW(rad=getattr(cfg, 'LOOP_RETR_RAD', 50))
        self.imcache = ImageCache()

        ctx = mp.get_context('spawn')
        self.lc_pool = ctx.Pool(processes=1)
        # the worker imports pgo (and torch) now, not at the first closure
        self.lc_process = self.lc_pool.apply_async(
            se3_to_sim3, (np.zeros((0, 7), np.float32),))
        self.manager = ctx.Manager()
        self.result_queue = self.manager.Queue()
        self.lc_in_progress = False

        self.loop_ii = np.zeros(0, np.int64)
        self.loop_jj = np.zeros(0, np.int64)
        self.lc_count = 0

        self.orb = cv2.ORB_create(nfeatures=2048)

    # ------------------------------------------------------------------ #
    def __call__(self, img, n):
        self.retrieval(img, n)
        self.imcache(img, n)

    def keyframe(self, k):
        self.retrieval.keyframe(k)
        self.imcache.keyframe(k)

    # ------------------------------------------------------------------ #
    def _detect(self, image):
        kps, desc = self.orb.detectAndCompute(image, None)
        if desc is None:
            return np.zeros((0, 2), np.float32), np.zeros((0, 32), np.uint8)
        pts = np.array([kp.pt for kp in kps], np.float32)
        return pts, desc

    def _match(self, d0, d1):
        if len(d0) == 0 or len(d1) == 0:
            return np.zeros((0, 2), np.int64)
        bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        matches = bf.match(d0, d1)
        return np.array([[m.queryIdx, m.trainIdx] for m in matches],
                        np.int64).reshape(-1, 2)

    def estimate_3d_keypoints(self, i):
        """Detect, match across the triplet [i-1, i, i+1], triangulate with
        structure-only BA (reference long_term.py:70-138)."""
        frames = self.imcache.load_frames([i - 1, i, i + 1])
        kps_l, desc_l = zip(*[self._detect(f) for f in frames])

        K = len(kps_l[1])
        if K < MIN_NUM_INLIERS:
            return None, None

        # trajectories: center-frame keypoints matched into both neighbors
        traj = np.full((K, 3), -1, np.int64)
        traj[:, 1] = np.arange(K)
        m01 = self._match(desc_l[0], desc_l[1])     # (q=frame0, t=frame1)
        traj[m01[:, 1], 0] = m01[:, 0]
        m21 = self._match(desc_l[2], desc_l[1])
        traj[m21[:, 1], 2] = m21[:, 0]
        traj = traj[traj.min(axis=1) >= 0]

        n = len(traj)
        if n < MIN_NUM_INLIERS:
            return None, None

        a, b, c = traj.T
        kps0 = kps_l[0][a]
        kps1 = kps_l[1][b]
        kps2 = kps_l[2][c]
        desc1 = desc_l[1][b]

        slam = self.slam
        M = slam.M
        true_disp = float(np.median(slam.depth_np[i * M:(i + 1) * M]))

        # mini patch graph at FULL resolution (intrinsics * 4)
        intr = slam.intr_np * 4.0
        depth_opt = triangulate(
            slam.poses_np[i - 1:i + 2], kps1,
            np.full(n, true_disp, np.float32), intr,
            np.concatenate([kps0, kps2], axis=0), device=slam.device)

        # residual gating: both reprojections within 2 px
        fx, fy, cx, cy = intr
        xn = (kps1[:, 0] - cx) / fx
        yn = (kps1[:, 1] - cy) / fy
        X0 = np.stack([xn, yn, np.ones(n), depth_opt], axis=-1).astype(np.float32)
        ok = np.ones(n, bool)
        for jf, tgt in ((0, kps0), (2, kps2)):
            Gij = nse3.mul(slam.poses_np[i - 1 + jf],
                           nse3.inv(slam.poses_np[i]))
            Xj = nse3.quat_rotate(Gij[3:7][None], X0[:, :3]) + \
                X0[:, 3:4] * Gij[:3][None]
            Z = np.maximum(Xj[:, 2], 0.1)
            px = fx * Xj[:, 0] / Z + cx
            py = fy * Xj[:, 1] / Z + cy
            ok &= np.hypot(px - tgt[:, 0], py - tgt[:, 1]) < 2.0

        if ok.sum() < 3:
            return None, None

        # un-project (camera-frame points of frame i)
        pts = X0[ok, :3] / np.maximum(depth_opt[ok, None], 1e-6)
        return pts, dict(keypoints=kps1[ok], descriptors=desc1[ok])

    # ------------------------------------------------------------------ #
    def attempt_loop_closure(self, n):
        if self.lc_in_progress:
            return

        cands = self.retrieval.detect_loop(
            thresh=self.cfg.LOOP_RETR_THRESH,
            num_repeat=self.cfg.LOOP_CLOSE_WINDOW_SIZE)
        if cands is not None:
            i, j = cands
            lc_result = self.close_loop(i, j, n)
            self.lc_count += int(lc_result)
            if lc_result:
                self.retrieval.confirm_loop(i, j)
            self.retrieval.found.clear()

        self.retrieval.save_up_to(n - self.cfg.REMOVAL_WINDOW - 2)
        self.imcache.save_up_to(n - self.cfg.REMOVAL_WINDOW - 1)

    def close_loop(self, i, j, n):
        i_pts, i_feat = self.estimate_3d_keypoints(i)
        j_pts, j_feat = self.estimate_3d_keypoints(j)
        if i_pts is None or j_pts is None:
            return False

        th = 20.0  # far-away points aren't helpful (long_term.py:215)
        im = i_pts[:, 2] < th
        jm = j_pts[:, 2] < th
        i_pts, j_pts = i_pts[im], j_pts[jm]
        i_desc = i_feat['descriptors'][im]
        j_desc = j_feat['descriptors'][jm]

        if len(i_pts) < MIN_NUM_INLIERS:
            return False

        matches = self._match(i_desc, j_desc)
        if len(matches) < MIN_NUM_INLIERS:
            return False
        i_pts = i_pts[matches[:, 0]].astype(np.float64)
        j_pts = j_pts[matches[:, 1]].astype(np.float64)

        r, t, s, num_inliers = ransac_umeyama(i_pts, j_pts, self.rng,
                                              iterations=400, threshold=0.1)
        if r is None or num_inliers < MIN_NUM_INLIERS:
            return False

        # previous loop constraints from the current estimate
        far_rel_pose = make_sim3(r, t, s)[None]
        slam = self.slam
        if len(self.loop_ii) > 0:
            Gi = slam.poses_np[self.loop_ii]
            Gj = slam.poses_np[self.loop_jj]
            Gij = nse3.mul(Gj, nse3.inv(Gi))
            prev_sim3 = se3_to_sim3(Gij)
        else:
            prev_sim3 = np.zeros((0, 8), np.float32)

        loop_poses = np.concatenate([prev_sim3, far_rel_pose], axis=0)
        loop_ii = np.concatenate([self.loop_ii, [i]])
        loop_jj = np.concatenate([self.loop_jj, [j]])

        # the PGO worker expects camera-to-world input (the reference inverts
        # here too, long_term.py:258); states inside are then world-to-camera
        # so the measured Sim3 (cam_i -> cam_j) slots in directly
        pred_poses = nse3.inv(slam.poses_np[:n])

        self.loop_ii = loop_ii
        self.loop_jj = loop_jj

        self.lc_in_progress = True
        self.lc_process = self.lc_pool.apply_async(
            run_DPVO_PGO,
            (pred_poses, loop_poses, loop_ii, loop_jj, self.result_queue))
        return True

    # ------------------------------------------------------------------ #
    def lc_callback(self, skip_if_empty=True):
        """Poll the PGO result and apply it (reference long_term.py:189-203).
        The PGO works on inverted poses: its (safe_i, 8) result is
        camera-to-world (reference long_term.py:200)."""
        if skip_if_empty and self.result_queue.empty():
            if self.lc_process.ready():
                self.lc_process.get()    # re-raises the worker's exception
            return
        self.lc_process.get()
        self.lc_in_progress = False
        apply_pgo_result(self.slam, self.result_queue.get())

    def terminate(self, n):
        self.retrieval.save_up_to(n - 1)
        self.imcache.save_up_to(n - 1)
        self.attempt_loop_closure(n)
        if self.lc_in_progress:
            self.lc_callback(skip_if_empty=False)
        self.close()
        print(f'LC COUNT: {self.lc_count}')

    def close(self):
        """Stop the worker processes (terminate() ends with this, after the
        last pose-graph result was applied, so none is pending)."""
        self.imcache.close()
        self.lc_pool.terminate()
        self.lc_pool.join()
        self.manager.shutdown()
        self.retrieval.close()
