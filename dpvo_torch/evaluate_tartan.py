"""TartanAir evaluation: the port of the root evaluate_tartan.py (reference
evaluate_tartan.py parity).

    python -m dpvo_torch.evaluate_tartan --weights dpvo.pth --trials 1

Protocol: stride 1, NED->xyz pose permutation [1,2,0,4,5,3,6], intrinsics
[320,320,320,240], AUC = mean(max(1-ATE, 0)); also train/cli.py's
in-training validation hook. Scenes and ground truth are read under
datasets/ in the working directory, as the root script reads them; the
validation split is data_readers.tartan.test_split, read when evaluate is
called. The root script's flags, plus --device (default cuda).
"""
import argparse
import glob
import os
import os.path as osp
from pathlib import Path

import cv2
import numpy as np

from .config import cfg
from .demo import require_device
from .evaluation import PoseTrajectory3D, ate_rmse
from .plot_utils import plot_trajectory
from .runtime import DPVO

STRIDE = 1
DEFAULT_CONFIG = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                          'config', 'default.yaml')


def video_iterator(imagedir, ext='.png', preload=False):
    imfiles = sorted(glob.glob(osp.join(imagedir, '*' + ext)))[::STRIDE]
    for t, imfile in enumerate(imfiles):
        image = cv2.imread(imfile)
        intrinsics = np.array([320.0, 320.0, 320.0, 240.0])
        h, w, _ = image.shape
        image = image[:h - h % 16, :w - w % 16]
        yield t, image, intrinsics


def run(imagedir, cfg, network, viz=False, seed=1234, device='cuda'):
    """(poses, tstamps) of DPVO over the images of imagedir."""
    slam = None
    for (t, image, intrinsics) in video_iterator(imagedir):
        if slam is None:
            H, W, _ = image.shape
            slam = DPVO(cfg, network, ht=H, wd=W, viz=viz, seed=seed,
                        device=device)
        slam(t, image, intrinsics)
    return slam.terminate()


def ate(traj_ref, traj_est):
    return ate_rmse(traj_est, traj_ref, correct_scale=True, max_diff=1e9)


def evaluate(config, net, split='validation', trials=1, plot=False,
             save=False, device='cuda'):
    """{'Tartan/<scene>': median ATE, 'AUC', 'AVG'} over the split's
    scenes, `trials` runs each with seed 1234 + trial. config None takes
    config/default.yaml (the root script merges it into its global cfg;
    here into a copy)."""
    require_device(device)
    if config is None:
        config = cfg.clone()
        config.merge_from_file(DEFAULT_CONFIG)

    if split == 'test':
        scenes = [x for x in os.listdir('datasets/mono')
                  if not x.endswith('.txt') and x != 'mono_gt']
    else:
        from .data_readers import tartan
        scenes = tartan.test_split

    results = {}
    all_results = []
    for i, scene in enumerate(scenes):
        results[scene] = []
        for j in range(trials):
            if split == 'test':
                scene_path = os.path.join('datasets/mono', scene)
                traj_ref_path = osp.join('datasets/mono', 'mono_gt',
                                         scene + '.txt')
            else:
                scene_path = os.path.join('datasets/TartanAir', scene,
                                          'image_left')
                traj_ref_path = osp.join('datasets/TartanAir', scene,
                                         'pose_left.txt')

            traj_est, tstamps = run(scene_path, config, net, seed=1234 + j,
                                    device=device)

            PERM = [1, 2, 0, 4, 5, 3, 6]  # ned -> xyz
            traj_ref = np.loadtxt(traj_ref_path, delimiter=' ')[::STRIDE, PERM]

            traj_est_obj = PoseTrajectory3D(
                positions_xyz=traj_est[:, :3],
                orientations_quat_wxyz=traj_est[:, [6, 3, 4, 5]],
                timestamps=tstamps)
            traj_ref_obj = PoseTrajectory3D(
                positions_xyz=traj_ref[:len(tstamps), :3],
                orientations_quat_wxyz=traj_ref[:len(tstamps), 3:][
                    :, [3, 0, 1, 2]],
                timestamps=tstamps)

            ate_score = ate(traj_ref_obj, traj_est_obj)
            all_results.append(ate_score)
            results[scene].append(ate_score)

            if plot:
                scene_name = '_'.join(scene.split('/')[1:]).title() \
                    if split == 'validation' else scene
                Path('trajectory_plots').mkdir(exist_ok=True)
                plot_trajectory(
                    traj_est_obj, traj_ref_obj,
                    f'TartanAir {scene_name} Trial #{j + 1} '
                    f'(ATE: {ate_score:.03f})',
                    f'trajectory_plots/TartanAir_{scene_name}_'
                    f'Trial{j + 1:02d}.pdf')

        print(scene, sorted(results[scene]))

    results_dict = {f'Tartan/{k}': np.median(v) for k, v in results.items()}
    xs = [np.median(v) for v in results.values()]
    results_dict['AUC'] = np.maximum(1 - np.array(all_results), 0).mean()
    results_dict['AVG'] = np.mean(xs)
    return results_dict


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--viz', action='store_true')
    parser.add_argument('--id', type=int, default=-1)
    parser.add_argument('--weights', default='dpvo.pth')
    parser.add_argument('--config', default='config/default.yaml')
    parser.add_argument('--split', default='validation')
    parser.add_argument('--trials', type=int, default=1)
    parser.add_argument('--backend_thresh', type=float, default=18.0)
    parser.add_argument('--plot', action='store_true')
    parser.add_argument('--opts', nargs='+', default=[])
    parser.add_argument('--save_trajectory', action='store_true')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    config = cfg.clone()
    config.merge_from_file(args.config)
    config.BACKEND_THRESH = args.backend_thresh
    config.merge_from_list(args.opts)

    print('Running with config...')
    print(config)

    results = evaluate(config, args.weights, split=args.split,
                       trials=args.trials, plot=args.plot,
                       save=args.save_trajectory, device=args.device)
    for k in results:
        print(k, results[k])
    return results


if __name__ == '__main__':
    main()
