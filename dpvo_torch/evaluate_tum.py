"""TUM-RGBD freiburg1 evaluation (the port of the root evaluate_tum.py,
reference evaluate_tum.py parity).

    python -m dpvo_torch.evaluate_tum --network dpvo.pth --trials 5

Flags, defaults and output paths are the root script's; --device (default
cuda) is added.
"""
from pathlib import Path

import cv2
import numpy as np

from .demo import evaluate, track
from .evaluation import PoseTrajectory3D, ate_rmse, read_tum_trajectory_file

SKIP = 0

SCENES = [
    'rgbd_dataset_freiburg1_360', 'rgbd_dataset_freiburg1_desk',
    'rgbd_dataset_freiburg1_desk2', 'rgbd_dataset_freiburg1_floor',
    'rgbd_dataset_freiburg1_plant', 'rgbd_dataset_freiburg1_room',
    'rgbd_dataset_freiburg1_rpy', 'rgbd_dataset_freiburg1_teddy',
    'rgbd_dataset_freiburg1_xyz',
]


def tum_image_stream(queue, scene_dir, sequence, stride, skip=0):
    images_dir = Path(scene_dir) / 'rgb'
    fx, fy, cx, cy = 517.3, 516.5, 318.6, 255.3
    K_l = np.array([fx, 0.0, cx, 0.0, fy, cy, 0.0, 0.0, 1.0]).reshape(3, 3)
    d_l = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])

    image_list = sorted(images_dir.glob('*.png'))[skip::stride]
    for imfile in image_list:
        image = cv2.imread(str(imfile))
        image = cv2.undistort(image, K_l, d_l)
        intrinsics = np.asarray([fx, fy, cx, cy])
        # crop distortion boundary (reference evaluate_tum.py:44-48)
        intrinsics[2] -= 16
        intrinsics[3] -= 8
        image = image[8:-8, 16:-16]
        queue.put((float(imfile.stem), image, intrinsics))
    queue.put((-1, image, intrinsics))


def run(cfg, network, scene_dir, sequence, stride=1, viz=False, seed=1234,
        device='cuda'):
    slam, _ = track(tum_image_stream, (scene_dir, sequence, stride, 0), cfg,
                    network, viz=viz, seed=seed, device=device)
    return slam.terminate()


def ate(traj_ref, traj_est, timestamps):
    """(ATE, estimate) of (T, 7) poses at the images' own timestamps."""
    traj_est_obj = PoseTrajectory3D(
        positions_xyz=traj_est[:, :3],
        orientations_quat_wxyz=traj_est[:, [6, 3, 4, 5]],
        timestamps=timestamps)
    return ate_rmse(traj_est_obj, traj_ref, correct_scale=True), traj_est_obj


def main(argv=None):
    def run_scene(cfg, args, scene, seed):
        scene_dir = args.tumdir / scene
        traj_ref = read_tum_trajectory_file(scene_dir / 'groundtruth.txt')
        traj_est, timestamps = run(cfg, args.network, scene_dir, scene,
                                   args.stride, args.viz, seed=seed,
                                   device=args.device)
        return (*ate(traj_ref, traj_est, timestamps), traj_ref)

    return evaluate(
        argv, SCENES, run_scene, data_flag='--tumdir',
        data_default='datasets/TUM_RGBD', data_type=Path, stride=1,
        title='TUM-RGBD {name} Trial #{trial} (ATE: {ate:.03f})',
        plot='trajectory_plots/TUM_{name}_Trial{trial:02d}.pdf',
        saved='saved_trajectories/TUM_{scene}.txt')


if __name__ == '__main__':
    main()
