"""Host-side visualization: the port of dpvo_tpu/viz/viewer.py.

The reference viewer (DPViewer/dpviewer/viewer.cpp:19-313) is a Pangolin
OpenGL app with CUDA-GL interop. This one, as dpvo_tpu's, is purely
host-side: it consumes pose/point snapshots pushed by the runtime and
renders either

  * live (cv2 window for the camera feed + matplotlib 3D scatter), when a
    display is available, or
  * headless (every 30th frame as a jpg, the point cloud as a ply, 3D
    renders as png and the interactive html, in `outdir`), otherwise.

It runs on its own thread with a queue handoff -- same process
architecture as the reference's std::thread + mutex image handoff
(viewer.cpp:36-41,101). Construction raises if the directory cannot be
made or the thread cannot start; a failed render inside the thread is
caught there, as dpvo_tpu does.
"""
from __future__ import annotations

import os
import queue
import threading
from pathlib import Path

import numpy as np


class Viewer:
    def __init__(self, outdir='viewer_out', live=None):
        self.q = queue.Queue(maxsize=4)
        self.outdir = Path(outdir)
        if live is None:
            live = bool(os.environ.get('DISPLAY'))
        self.live = live
        if not live:
            self.outdir.mkdir(parents=True, exist_ok=True)
        self._count = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    # ------------------------------------------------------------------ #
    # producer API (mirrors dpviewer.Viewer)
    # ------------------------------------------------------------------ #

    def update_image(self, image):
        try:
            self.q.put_nowait(('image', np.asarray(image)))
        except queue.Full:
            pass

    def update_points(self, points, colors):
        """Queue a point cloud (headless: written as cloud.ply). Unlike the
        per-frame pushes, this one waits up to 5 s for room: the demo
        pushes the final cloud once, and dropping it would lose the
        artifact."""
        self.q.put(('points', (np.asarray(points), np.asarray(colors))),
                   timeout=5)

    def update_state(self, poses_wfc, points, colors):
        """Push a full SLAM-state snapshot for 3D rendering.

        poses_wfc: (N, 7) world-from-camera [x y z qx qy qz qw]
        points:    (K, 3) world points;  colors: (K, 3) RGB [0, 255]
        Renders camera frusta + trajectory + point cloud (the reference
        viewer's content, DPViewer/dpviewer/viewer.cpp:104-218).
        """
        try:
            self.q.put_nowait(('state', (np.asarray(poses_wfc, np.float32),
                                         np.asarray(points, np.float32),
                                         np.asarray(colors, np.float32))))
        except queue.Full:
            pass

    def join(self, timeout=60.0):
        """Stop the render thread once it has handled everything queued
        before this call (the final cloud included: a slow 3D render must
        not drop it); raise if it has not finished within `timeout` s."""
        if self.thread.is_alive():
            self.q.put(('stop', None), timeout=timeout)
            self.thread.join(timeout=timeout)
        if self.thread.is_alive():
            raise RuntimeError(f'the viewer thread did not finish within '
                               f'{timeout} s')

    # ------------------------------------------------------------------ #
    def _loop(self):
        import cv2
        while True:
            kind, payload = self.q.get()
            if kind == 'stop':
                break
            if kind == 'image':
                if self.live:
                    try:
                        cv2.imshow('dpvo_torch', payload)
                        cv2.waitKey(1)
                    except Exception:
                        self.live = False
                if not self.live and self._count % 30 == 0:
                    cv2.imwrite(str(self.outdir / f'frame_{self._count:06d}.jpg'),
                                payload)
                self._count += 1
            elif kind == 'points':
                points, colors = payload
                if not self.live:
                    self._save_cloud(points, colors)
            elif kind == 'state':
                # live matplotlib is main-thread-only on some platforms;
                # degrade to headless PNGs like the cv2.imshow path above
                try:
                    self._render_3d(*payload)
                except Exception:
                    if self.live:
                        self.live = False
                        try:
                            self._render_3d(*payload)
                        except Exception:
                            pass
                # refresh the interactive artifact (the headless answer to
                # the reference's live Pangolin navigation), THROTTLED:
                # rebuilding is O(map size) host work on a ~2-core box
                import time as _time
                now = _time.time()
                if now - getattr(self, '_last_html', 0.0) > 5.0:
                    self._last_html = now
                    try:
                        from .html_viewer import save_html_viewer
                        save_html_viewer(str(self.outdir / 'viewer.html'),
                                         *payload)
                    except Exception:
                        pass

    def _save_cloud(self, points, colors):
        from ..plot_utils import save_ply
        save_ply(str(self.outdir / 'cloud.ply'), points, colors)

    # ------------------------------------------------------------------ #
    # 3D rendering (frusta + cloud), matplotlib backend
    # ------------------------------------------------------------------ #

    @staticmethod
    def _frustum(pose_wfc, scale=0.15):
        """Camera frustum polyline (5 corners + apex) in world coords."""
        from ..runtime import numpy_se3 as nse3
        w, h, z = 0.8 * scale, 0.5 * scale, 1.0 * scale
        corners = np.array([[0, 0, 0], [-w, -h, z], [w, -h, z],
                            [0, 0, 0], [-w, h, z], [w, h, z],
                            [0, 0, 0], [w, -h, z], [w, h, z],
                            [0, 0, 0], [-w, -h, z], [-w, h, z]], np.float32)
        return nse3.act(pose_wfc[None], corners)

    def _render_3d(self, poses_wfc, points, colors):
        import matplotlib
        if not self.live:
            matplotlib.use('Agg')
        import matplotlib.pyplot as plt

        if not hasattr(self, '_fig3d'):
            self._fig3d = plt.figure(figsize=(7, 7))
            self._ax3d = self._fig3d.add_subplot(111, projection='3d')
            self._n3d = 0
        ax = self._ax3d
        ax.cla()

        if len(points):
            keep = np.isfinite(points).all(axis=1)
            pts, clr = points[keep], colors[keep]
            if len(pts) > 20000:
                sel = np.random.default_rng(0).choice(len(pts), 20000,
                                                      replace=False)
                pts, clr = pts[sel], clr[sel]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5,
                       c=np.clip(clr / 255.0, 0, 1))
        traj = poses_wfc[:, :3]
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], 'b-', linewidth=1)
        scale = max(float(np.ptp(traj, axis=0).max()), 1e-3) * 0.05
        for p in poses_wfc[::max(1, len(poses_wfc) // 40)]:
            f = self._frustum(p, scale)
            ax.plot(f[:, 0], f[:, 1], f[:, 2], 'r-', linewidth=0.6)
        ax.set_box_aspect((1, 1, 1))
        ax.set_title(f'{len(poses_wfc)} keyframes')

        if self.live:
            plt.pause(0.001)
        else:
            self.outdir.mkdir(parents=True, exist_ok=True)
            self._fig3d.savefig(self.outdir / f'traj3d_{self._n3d:06d}.png',
                                dpi=80)
        self._n3d += 1
