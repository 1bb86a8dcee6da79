"""KITTI odometry evaluation (the port of the root evaluate_kitti.py,
reference evaluate_kitti.py parity).

    python -m dpvo_torch.evaluate_kitti --network dpvo.pth --trials 5

Flags, defaults and output paths are the root script's; --device (default
cuda) is added.
"""
from pathlib import Path

import cv2
import numpy as np

from .demo import evaluate, track
from .evaluation import PoseTrajectory3D, ate_rmse

SEQUENCES = [f'{i:02d}' for i in range(11)]


def read_calib_file(filepath):
    data = {}
    with open(filepath) as f:
        for line in f.readlines():
            key, value = line.split(':', 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


def kitti_image_stream(queue, kittidir, sequence, stride, skip=0):
    images_dir = Path(kittidir) / 'dataset' / 'sequences' / sequence
    image_list = sorted((images_dir / 'image_2').glob('*.png'))[skip::stride]
    calib = read_calib_file(images_dir / 'calib.txt')
    intrinsics = calib['P0'][[0, 5, 2, 6]]

    for t, imfile in enumerate(image_list):
        image = cv2.imread(str(imfile))
        H, W, _ = image.shape
        H, W = H - H % 4, W - W % 4
        image = image[:H, :W]
        queue.put((t, image, intrinsics))
    queue.put((-1, image, intrinsics))


def run(cfg, network, kittidir, sequence, stride=1, viz=False, seed=1234,
        device='cuda'):
    slam, _ = track(kitti_image_stream, (kittidir, sequence, stride, 0), cfg,
                    network, viz=viz, seed=seed, device=device)
    return slam.terminate()


def load_kitti_gt(kittidir, sequence):
    """KITTI poses file: 3x4 row-major world-from-camera matrices."""
    pose_file = Path(kittidir) / 'dataset' / 'poses' / f'{sequence}.txt'
    mats = np.loadtxt(pose_file).reshape(-1, 3, 4)
    positions = mats[:, :, 3]
    # rotation -> quaternion wxyz
    quats = []
    for R in mats[:, :, :3]:
        w = np.sqrt(max(0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
        w = max(w, 1e-8)
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
        quats.append([w, x, y, z])
    return positions, np.asarray(quats)


def ate(pos_gt, quat_gt, traj_est, tstamps, stride):
    """(ATE, estimate): the estimate's i-th pose against ground-truth
    pose i * stride, associated by index."""
    n = len(traj_est)
    gt_idx = (np.arange(n) * stride).clip(max=len(pos_gt) - 1)
    traj_ref = PoseTrajectory3D(
        positions_xyz=pos_gt[gt_idx],
        orientations_quat_wxyz=quat_gt[gt_idx],
        timestamps=tstamps)
    traj_est_obj = PoseTrajectory3D(
        positions_xyz=traj_est[:, :3],
        orientations_quat_wxyz=traj_est[:, [6, 3, 4, 5]],
        timestamps=tstamps)
    return (ate_rmse(traj_est_obj, traj_ref, correct_scale=True,
                     max_diff=1e9), traj_est_obj, traj_ref)


def main(argv=None):
    def run_scene(cfg, args, sequence, seed):
        pos_gt, quat_gt = load_kitti_gt(args.kittidir, sequence)
        traj_est, tstamps = run(cfg, args.network, args.kittidir, sequence,
                                args.stride, args.viz, seed=seed,
                                device=args.device)
        return ate(pos_gt, quat_gt, traj_est, tstamps, args.stride)

    return evaluate(
        argv, SEQUENCES, run_scene,
        data_flag='--kittidir', data_default='datasets/KITTI',
        data_type=Path, stride=2, backend_thresh=32.0,
        title='KITTI {name} Trial #{trial} (ATE: {ate:.03f})',
        plot='trajectory_plots/KITTI_{name}_Trial{trial:02d}.pdf',
        saved='saved_trajectories/KITTI_{scene}.txt')


if __name__ == '__main__':
    main()
