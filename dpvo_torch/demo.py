"""Run VO / SLAM on an image directory or a video (the port of the root
demo.py, reference demo.py parity).

    python -m dpvo_torch.demo --imagedir DIR --calib calib/euroc.txt \
        --network dpvo.pth --stride 1 --viz --plot --save_ply

Flags, defaults and output paths (relative to the working directory) are
the root demo.py's; --device (default cuda) is the one flag added, and
--device cuda on a host with no GPU raises. A spawn reader process
(stream.py) decodes frames into a queue; the runtime (DPVO: DeviceVO for
pure VO, HybridVO for --viz and the SLAM configs) tracks them. With --viz
the viewer (viz/viewer.py) writes its headless artifacts to viewer_out/
and gets the final point cloud.
"""
import argparse
import multiprocessing as _mp
import os
import queue as _queue
from pathlib import Path

import numpy as np
import torch

from .config import cfg
from .evaluation import poses_to_trajectory, save_trajectory_tum_format
from .plot_utils import plot_trajectory, save_output_for_COLMAP, save_ply
from .runtime import DPVO
from .stream import image_stream, video_stream
from .utils import Timer

# spawn, not fork: torch is multithreaded by the time readers start
# (reference sets spawn globally, dpvo/dpvo.py:13)
_ctx = _mp.get_context('spawn')


def require_device(device):
    """Raise unless `device` exists here: an entry point asked for cuda
    does not go on on the CPU."""
    if torch.device(device).type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {device}: no CUDA device is available '
                           f'(pass --device cpu to run on the CPU)')


def _next_frame(queue, proc):
    """The reader's next item; raise if the reader process has ended with
    nothing left on the queue (it died before its sentinel: an empty or
    wrong image directory, an unreadable image)."""
    while True:
        try:
            return queue.get(timeout=1.0)
        except _queue.Empty:
            if proc.is_alive():
                continue
        try:                     # what it put before it ended
            return queue.get(timeout=1.0)
        except _queue.Empty:
            raise RuntimeError(f'the frame reader ended (exit code '
                               f'{proc.exitcode}) before the end of its '
                               f'stream') from None


def track(reader, args, cfg, network, *, viz=False, seed=1234,
          device='cuda', timeit=False):
    """Track every frame that `reader(queue, *args)` puts on a queue, in a
    spawn process, until its (-1, ...) sentinel. Returns (slam, last
    intrinsics); the caller terminates slam. The runtime is built at the
    first frame, at its size. A reader that ends before its sentinel
    raises RuntimeError."""
    require_device(device)
    slam = None
    queue = _ctx.Queue(maxsize=8)
    proc = _ctx.Process(target=reader, args=(queue, *args))
    proc.start()
    try:
        while True:
            (t, image, intrinsics) = _next_frame(queue, proc)
            if t < 0:
                break
            if slam is None:
                H, W, _ = image.shape
                slam = DPVO(cfg, network, ht=H, wd=W, viz=viz, seed=seed,
                            device=device)
            with Timer('SLAM', enabled=timeit, device=device):
                slam(t, image, intrinsics)
    except BaseException:
        proc.terminate()          # it may be blocked on the full queue
        raise
    finally:
        proc.join()
    return slam, intrinsics


def evaluate(argv, scenes, run_scene, *, data_flag, data_default,
             data_type=str, stride=2, backend_thresh=64.0, title, plot,
             saved, label=str):
    """The evaluation CLIs' main (evaluate_euroc, _tum, _kitti, _icl_nuim):
    the root scripts' flags (dataset directory `data_flag`, default
    stride and backend_thresh per CLI) plus --device, the config merge,
    --trials runs of each scene with seed 1234 + trial, the --plot and
    --save_trajectory writers, the per-scene median ATE and the AVG of
    the medians. run_scene(cfg, args, scene, seed) returns (ATE,
    estimate, reference), the two as PoseTrajectory3D. title, plot and
    saved are the root's plot title, plot path and trajectory path as
    format strings of scene, name = label(scene), trial (from 1) and ate.
    Returns ({scene: median ATE}, AVG)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--network', type=str, default='dpvo.pth')
    parser.add_argument('--config', default='config/default.yaml')
    parser.add_argument('--stride', type=int, default=stride)
    parser.add_argument('--viz', action='store_true')
    parser.add_argument('--trials', type=int, default=1)
    parser.add_argument(data_flag, default=data_default, type=data_type)
    parser.add_argument('--backend_thresh', type=float,
                        default=backend_thresh)
    parser.add_argument('--plot', action='store_true')
    parser.add_argument('--opts', nargs='+', default=[])
    parser.add_argument('--save_trajectory', action='store_true')
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args(argv)

    cfg.merge_from_file(args.config)
    cfg.BACKEND_THRESH = args.backend_thresh
    cfg.merge_from_list(args.opts)

    print('Running with config...')
    print(cfg)

    results = {}
    for scene in scenes:
        scene_results = []
        for trial in range(args.trials):
            err, traj_est, traj_ref = run_scene(cfg, args, scene,
                                                1234 + trial)
            scene_results.append(err)
            names = dict(scene=scene, name=label(scene), trial=trial + 1,
                         ate=err)
            if args.plot:
                Path('trajectory_plots').mkdir(exist_ok=True)
                plot_trajectory(traj_est, traj_ref, title.format(**names),
                                plot.format(**names))
            if args.save_trajectory:
                Path('saved_trajectories').mkdir(exist_ok=True)
                save_trajectory_tum_format(traj_est, saved.format(**names))

        results[scene] = np.median(scene_results)
        print(scene, sorted(scene_results))

    for scene in results:
        print(scene, results[scene])
    avg = np.mean(list(results.values()))
    print('AVG', avg)
    return results, avg


def run(cfg, network, imagedir, calib, stride=1, skip=0, viz=False,
        timeit=False, device='cuda'):
    """((poses, tstamps), (points, colors, (fx, fy, cx, cy, H, W))) of a
    run over an image directory or a video file, as the root demo.run."""
    reader = image_stream if os.path.isdir(imagedir) else video_stream
    slam, intrinsics = track(reader, (imagedir, calib, stride, skip), cfg,
                             network, viz=viz, device=device, timeit=timeit)
    points = slam.point_cloud()
    colors = slam.colors().reshape(-1, 3)
    if slam.viewer is not None:
        slam.viewer.update_points(points, colors)
    return slam.terminate(), (points, colors,
                              (*intrinsics, slam.ht, slam.wd))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--network', type=str, default='dpvo.pth')
    parser.add_argument('--imagedir', type=str)
    parser.add_argument('--calib', type=str)
    parser.add_argument('--name', type=str, help='name your run', default='result')
    parser.add_argument('--stride', type=int, default=2)
    parser.add_argument('--skip', type=int, default=0)
    parser.add_argument('--config', default='config/default.yaml')
    parser.add_argument('--timeit', action='store_true')
    parser.add_argument('--viz', action='store_true')
    parser.add_argument('--plot', action='store_true')
    parser.add_argument('--opts', nargs='+', default=[])
    parser.add_argument('--save_ply', action='store_true')
    parser.add_argument('--save_html', action='store_true',
                        help='interactive WebGL viewer (one self-contained '
                             '.html: orbit/pan/zoom, frusta + point cloud)')
    parser.add_argument('--save_colmap', action='store_true')
    parser.add_argument('--save_trajectory', action='store_true')
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (cuda, cuda:1, cpu)')
    args = parser.parse_args(argv)

    cfg.merge_from_file(args.config)
    cfg.merge_from_list(args.opts)

    print('Running with config...')
    print(cfg)

    (poses, tstamps), (points, colors, calib) = run(
        cfg, args.network, args.imagedir, args.calib, args.stride, args.skip,
        args.viz, args.timeit, device=args.device)

    trajectory = poses_to_trajectory(poses, tstamps)

    if args.save_ply:
        save_ply(args.name + '.ply', points, colors)

    if args.save_colmap:
        save_output_for_COLMAP(args.name, trajectory, points, colors, *calib)

    if args.save_html:
        from .viz.html_viewer import save_html_viewer
        save_html_viewer(args.name + '.html', poses, points, colors,
                         title=args.name)
        print(f'interactive viewer: {args.name}.html')

    if args.save_trajectory:
        Path('saved_trajectories').mkdir(exist_ok=True)
        save_trajectory_tum_format(trajectory,
                                   f'saved_trajectories/{args.name}.txt')

    if args.plot:
        Path('trajectory_plots').mkdir(exist_ok=True)
        plot_trajectory(trajectory, title=f'DPVO Trajectory {args.name}',
                        filename=f'trajectory_plots/{args.name}.pdf')


if __name__ == '__main__':
    main()
