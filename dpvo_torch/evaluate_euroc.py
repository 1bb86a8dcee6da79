"""EuRoC evaluation (the port of the root evaluate_euroc.py, reference
evaluate_euroc.py parity).

    python -m dpvo_torch.evaluate_euroc --network dpvo.pth --trials 5

Protocol (BASELINE.md): stride 2, N trials with seed 1234+trial, per-scene
median ATE RMSE after Sim3 alignment, AVG of medians. Flags, defaults and
output paths are the root script's; --device (default cuda) is added.
"""
from pathlib import Path

import numpy as np

from .demo import evaluate, track
from .evaluation import PoseTrajectory3D, ate_rmse, poses_to_trajectory
from .stream import image_stream

SKIP = 0

SCENES = [
    'MH_01_easy', 'MH_02_easy', 'MH_03_medium', 'MH_04_difficult',
    'MH_05_difficult', 'V1_01_easy', 'V1_02_medium', 'V1_03_difficult',
    'V2_01_easy', 'V2_02_medium', 'V2_03_difficult',
]


def run(cfg, network, imagedir, calib, stride=1, viz=False, seed=1234,
        device='cuda'):
    slam, _ = track(image_stream, (imagedir, calib, stride, SKIP), cfg,
                    network, viz=viz, seed=seed, device=device)
    return slam.terminate()


def ate(traj_ref, traj_est, timestamps):
    traj_est = poses_to_trajectory(traj_est, timestamps)
    return ate_rmse(traj_est, traj_ref, correct_scale=True), traj_est


def load_groundtruth(path):
    """The reference's euroc_groundtruth/<scene>.txt: ns timestamp, xyz,
    quaternion wxyz, space-separated."""
    gt = np.loadtxt(path, delimiter=' ')
    return PoseTrajectory3D(positions_xyz=gt[:, 1:4],
                            orientations_quat_wxyz=gt[:, 4:8],
                            timestamps=gt[:, 0] / 1e9)


def image_timestamps(imagedir, stride, n):
    """Seconds of the first n tracked images (EuRoC names images by their
    ns timestamps; the runtime tracks frame indices)."""
    images = sorted(Path(imagedir).glob('*.png'))[::stride]
    return np.array([float(p.stem) / 1e9 for p in images])[:n]


def main(argv=None):
    def run_scene(cfg, args, scene, seed):
        imagedir = f'{args.eurocdir}/{scene}/mav0/cam0/data'
        traj_est, tstamps = run(cfg, args.network, imagedir,
                                'calib/euroc.txt', args.stride, args.viz,
                                seed=seed, device=args.device)
        traj_ref = load_groundtruth(
            f'datasets/euroc_groundtruth/{scene}.txt')
        tss = image_timestamps(imagedir, args.stride, len(tstamps))
        return (*ate(traj_ref, traj_est, tss), traj_ref)

    return evaluate(
        argv, SCENES, run_scene, data_flag='--eurocdir',
        data_default='datasets/EUROC', stride=2,
        title='EuRoC {name} Trial #{trial} (ATE: {ate:.03f})',
        plot='trajectory_plots/euroc_{name}_trial{trial:02d}.pdf',
        saved='saved_trajectories/euroc_{scene}.txt')


if __name__ == '__main__':
    main()
