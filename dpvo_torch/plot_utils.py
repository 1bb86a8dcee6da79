"""Trajectory plotting and point-cloud export.

Copy of dpvo_tpu/plot_utils.py (numpy; matplotlib inside plot_trajectory),
pointed at this package's evaluation.py and runtime/numpy_se3.py. Mirrors
the reference dpvo/plot_utils.py:11-64 (evo plots, PLY export, COLMAP text
model) without the evo/plyfile dependencies.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def plot_trajectory(pred_traj, gt_traj=None, title='', filename='',
                    align=True, correct_scale=True):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    from .evaluation import umeyama_alignment

    p = pred_traj.positions_xyz.T
    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_traj is not None:
        g_full = gt_traj.positions_xyz.T
        if align:
            from .evaluation import associate
            ei, gi = associate(pred_traj.timestamps, gt_traj.timestamps)
            if len(ei) >= 3:
                R, t, c = umeyama_alignment(p[:, ei], g_full[:, gi],
                                            with_scale=correct_scale)
                p = c * R @ p + t
        ax.plot(g_full[0], g_full[1], '--', color='gray', label='Ground Truth')
    ax.plot(p[0], p[1], '-', color='#1f77b4', label='Predicted')
    ax.set_title(title)
    ax.legend()
    ax.set_aspect('equal', adjustable='datalim')
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(filename, dpi=120)
    plt.close(fig)


def save_ply(filename, points, colors):
    """Binary little-endian PLY (replaces plyfile, reference :59-64)."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.uint8)
    n = len(points)
    header = (
        'ply\nformat binary_little_endian 1.0\n'
        f'element vertex {n}\n'
        'property float x\nproperty float y\nproperty float z\n'
        'property uchar red\nproperty uchar green\nproperty uchar blue\n'
        'end_header\n')
    rec = np.empty(n, dtype=[('xyz', np.float32, 3), ('rgb', np.uint8, 3)])
    rec['xyz'] = points
    rec['rgb'] = colors
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    with open(filename, 'wb') as f:
        f.write(header.encode('ascii'))
        f.write(rec.tobytes())


def save_output_for_COLMAP(name, traj, points, colors, fx, fy, cx, cy,
                           H=480, W=640):
    """Export trajectory + point cloud as a COLMAP text model
    (reference plot_utils.py:34-57)."""
    colmap_dir = Path(name)
    colmap_dir.mkdir(exist_ok=True, parents=True)
    scale = 10  # for visualization

    # points3D.txt
    with open(colmap_dir / 'points3D.txt', 'w') as f:
        for i, (p, c) in enumerate(zip(points, colors)):
            f.write(f'{i + 1} {p[0] * scale} {p[1] * scale} {p[2] * scale} '
                    f'{int(c[0])} {int(c[1])} {int(c[2])} 0.0\n')

    # images.txt (world-to-camera)
    from .runtime import numpy_se3 as nse3
    with open(colmap_dir / 'images.txt', 'w') as f:
        for i in range(len(traj.timestamps)):
            t = traj.positions_xyz[i] * scale
            qw, qx, qy, qz = traj.orientations_quat_wxyz[i]
            g = np.array([t[0], t[1], t[2], qx, qy, qz, qw], np.float32)
            ginv = nse3.inv(g)
            tw = ginv[:3]
            qxw, qyw, qzw, qww = ginv[3:7]
            f.write(f'{i + 1} {qww} {qxw} {qyw} {qzw} '
                    f'{tw[0]} {tw[1]} {tw[2]} 1 frame_{i:06d}.png\n\n')

    with open(colmap_dir / 'cameras.txt', 'w') as f:
        f.write(f'1 PINHOLE {W} {H} {fx} {fy} {cx} {cy}\n')
