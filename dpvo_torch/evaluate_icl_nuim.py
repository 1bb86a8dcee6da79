"""ICL-NUIM evaluation (the port of the root evaluate_icl_nuim.py,
reference evaluate_icl_nuim.py parity).

    python -m dpvo_torch.evaluate_icl_nuim --network dpvo.pth --trials 5

Flags, defaults and output paths are the root script's; --device (default
cuda) is added.
"""
import glob
import os
from pathlib import Path

import numpy as np

from .demo import evaluate, track
from .evaluation import PoseTrajectory3D, ate_rmse, read_tum_trajectory_file
from .stream import image_stream

SCENES = [
    'living_room_traj0_loop', 'living_room_traj1_loop',
    'living_room_traj2_loop', 'living_room_traj3_loop',
    'office_room_traj0_loop', 'office_room_traj1_loop',
    'office_room_traj2_loop', 'office_room_traj3_loop',
]


def run(cfg, network, imagedir, calib, stride=1, viz=False, seed=1234,
        device='cuda'):
    slam, _ = track(image_stream, (str(imagedir), calib, stride, 0), cfg,
                    network, viz=viz, seed=seed, device=device)
    return slam.terminate()


def groundtruth_path(iclnuim_dir, scene):
    """The scene's TUM-format ground truth under TrajectoryGT/."""
    if scene.startswith('living'):
        return Path(iclnuim_dir) / 'TrajectoryGT' / \
            f'livingRoom{scene[-6]}.gt.freiburg'
    return Path(iclnuim_dir) / 'TrajectoryGT' / f'traj{scene[-6]}.gt.freiburg'


def ate(traj_ref, traj_est, imagedir, stride):
    """(ATE, estimate): frame i of the stride-subsampled images gets the
    timestamp 1 + i * stride, as the root script assigns them."""
    images_list = sorted(glob.glob(
        os.path.join(imagedir, '*.png')))[::stride]
    tstamps = np.arange(1, len(images_list) + 1, stride,
                        dtype=np.float64)[:len(traj_est)]
    traj_est_obj = PoseTrajectory3D(
        positions_xyz=traj_est[:len(tstamps), :3],
        orientations_quat_wxyz=traj_est[:len(tstamps), [6, 3, 4, 5]],
        timestamps=tstamps)
    return (ate_rmse(traj_est_obj, traj_ref, correct_scale=True,
                     max_diff=0.6), traj_est_obj)


def main(argv=None):
    def run_scene(cfg, args, scene, seed):
        imagedir = args.iclnuim_dir / scene
        traj_ref = read_tum_trajectory_file(
            groundtruth_path(args.iclnuim_dir, scene))
        traj_est, _ = run(cfg, args.network, imagedir, 'calib/icl_nuim.txt',
                          args.stride, args.viz, seed=seed,
                          device=args.device)
        return (*ate(traj_ref, traj_est, imagedir, args.stride), traj_ref)

    return evaluate(
        argv, SCENES, run_scene, data_flag='--iclnuim_dir',
        data_default='datasets/ICL_NUIM', data_type=Path, stride=2,
        title='ICL_NUIM {name} Trial #{trial} (ATE: {ate:.03f})',
        plot='trajectory_plots/ICL_NUIM_{name}_Trial{trial:02d}.pdf',
        saved='saved_trajectories/ICL_NUIM_{scene}.txt',
        label=lambda scene: scene.rstrip('_loop').title())


if __name__ == '__main__':
    main()
