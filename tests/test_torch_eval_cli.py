"""The evaluation CLIs: dpvo_torch's evaluate_euroc, evaluate_tum,
evaluate_kitti, evaluate_icl_nuim and evaluate_synthetic against the root
scripts, on the CPU, on small inputs written to tmp_path (no dataset is in
the repo).

* The readers: on a fake layout of each dataset the port's frames,
  intrinsics and ground truth equal the root CLI's, exactly; the port's
  run + ate on that scene (the motion probe forced, as in
  test_torch_cli.py) gives a finite ATE.
* evaluate_synthetic: one scene (synth_900) and one trial, the port's
  protocol against the root's (scripts/train_synthetic.py:run_vo_ate),
  both over default.yaml merged into their package's config as the CLIs
  merge it: ATE within 1e-3 (f32 on both sides; the trajectories agree to
  test_torch_runtime.py's 1e-3 per pose component, and the aligned RMSE
  moves by less).
"""
import os

import cv2
import numpy as np
import pytest

import evaluate_kitti as root_kitti
import evaluate_synthetic as root_synthetic
import evaluate_tum as root_tum
from dpvo_torch import accuracy as tacc
from dpvo_torch import demo as tdemo
from dpvo_torch import evaluate_euroc as teuroc
from dpvo_torch import evaluate_icl_nuim as ticl
from dpvo_torch import evaluate_kitti as tkitti
from dpvo_torch import evaluate_synthetic as tsynthetic
from dpvo_torch import evaluate_tum as ttum
from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.data_readers.synthetic import make_sequence
from dpvo_torch.evaluation import read_tum_trajectory_file as t_read_tum
from dpvo_torch.stream import image_stream as t_image_stream
from dpvo_tpu import config as jax_config
from dpvo_tpu.evaluation import PoseTrajectory3D as JaxTraj
from dpvo_tpu.evaluation import read_tum_trajectory_file as j_read_tum
from dpvo_tpu.stream import image_stream as j_image_stream
from test_torch_cli import H, W, _forced, _small_cfg, _write_frames
from test_torch_runtime import NPZ, REPO, torch_threads
from test_torch_viewer import _assert_same_items, _drain


def _gt_wxyz(n):
    """Ground-truth positions (n, 3) moving along x and unit quaternions
    wxyz (n, 4) of a small yaw."""
    pos = np.stack([0.05 * np.arange(n), 0.01 * np.sin(np.arange(n)),
                    np.zeros(n)], 1)
    yaw = 0.02 * np.arange(n)
    q = np.stack([np.cos(yaw / 2), np.zeros(n), np.sin(yaw / 2),
                  np.zeros(n)], 1)
    return pos, q



N_EVAL = 10


def _euroc(tmp_path):
    """EuRoC layout: mav0/cam0/data/<ns>.png, calib/euroc.txt (with
    distortion), euroc_groundtruth/<scene>.txt (ns, xyz, wxyz)."""
    ns = (1403636579763555584 + 50_000_000 * np.arange(N_EVAL)).astype(
        np.int64)
    imagedir = _write_frames(
        tmp_path / 'EUROC' / 'MH_01_easy' / 'mav0' / 'cam0' / 'data',
        [f'{t}.png' for t in ns])
    pos, q = _gt_wxyz(N_EVAL)
    gt = tmp_path / 'gt.txt'
    np.savetxt(gt, np.concatenate([ns[:, None].astype(float), pos, q], 1),
               delimiter=' ', fmt='%.17g')
    calib = os.path.join(REPO, 'calib', 'euroc.txt')

    # the root script's inline ground truth (evaluate_euroc.py:94-98) and
    # image timestamps (:101-102)
    g = np.loadtxt(gt, delimiter=' ')
    want_gt = JaxTraj(positions_xyz=g[:, 1:4], orientations_quat_wxyz=g[:, 4:8],
                      timestamps=g[:, 0] / 1e9)
    want_ts = np.array([float(p.stem) / 1e9 for p in
                        sorted(imagedir.glob('*.png'))])[:N_EVAL]
    frames = (_drain(t_image_stream, str(imagedir), calib, 1, 0),
              _drain(j_image_stream, str(imagedir), calib, 1, 0))
    truth = ((teuroc.load_groundtruth(gt), want_gt),
             (teuroc.image_timestamps(imagedir, 1, N_EVAL), want_ts))

    def run_ate(cfg):
        poses, tstamps = teuroc.run(cfg, NPZ, str(imagedir), calib, 1,
                                    device='cpu')
        ts = teuroc.image_timestamps(imagedir, 1, len(tstamps))
        return teuroc.ate(teuroc.load_groundtruth(gt), poses, ts)[0]
    return frames, truth, run_ate


def _tum(tmp_path):
    """TUM-RGBD layout: <scene>/rgb/<stamp>.png (80x128, cropped to 64x96
    after undistortion), <scene>/groundtruth.txt."""
    stamps = [f'{1305031102.175304 + 0.033 * t:.6f}' for t in range(N_EVAL)]
    scene = tmp_path / 'rgbd_dataset_freiburg1_xyz'
    _write_frames(scene / 'rgb', [f'{s}.png' for s in stamps], 80, 128)
    pos, q = _gt_wxyz(N_EVAL)
    rows = np.concatenate([np.array(stamps, float)[:, None], pos,
                           q[:, [1, 2, 3, 0]]], 1)
    np.savetxt(scene / 'groundtruth.txt', rows, fmt='%.17g',
               header='timestamp tx ty tz qx qy qz qw')
    frames = (_drain(ttum.tum_image_stream, scene, 'x', 1, 0),
              _drain(root_tum.tum_image_stream, scene, 'x', 1, 0))
    truth = ((t_read_tum(scene / 'groundtruth.txt'),
              j_read_tum(scene / 'groundtruth.txt')),)

    def run_ate(cfg):
        poses, tstamps = ttum.run(cfg, NPZ, scene, 'x', 1, device='cpu')
        return ttum.ate(t_read_tum(scene / 'groundtruth.txt'), poses,
                        tstamps)[0]
    return frames, truth, run_ate


def _kitti(tmp_path):
    """KITTI layout: dataset/sequences/00/image_2/*.png (66x98, cropped to
    multiples of 4), calib.txt (P0..P3 rows), dataset/poses/00.txt."""
    seqdir = tmp_path / 'KITTI' / 'dataset' / 'sequences' / '00'
    _write_frames(seqdir / 'image_2', [f'{t:06d}.png' for t in range(N_EVAL)],
                  66, 98)
    P = '60.0 0.0 48.0 0.0 0.0 61.0 32.0 0.0 0.0 0.0 1.0 0.0'
    (seqdir / 'calib.txt').write_text(
        ''.join(f'P{i}: {P}\n' for i in range(4)) + 'Tr: not numbers\n')
    pos, q = _gt_wxyz(N_EVAL)
    w, x, y, z = q.T
    R = np.stack([np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                            2 * (x * z + y * w)], -1),
                  np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                            2 * (y * z - x * w)], -1),
                  np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                            1 - 2 * (x * x + y * y)], -1)], 1)
    (tmp_path / 'KITTI' / 'dataset' / 'poses').mkdir(parents=True)
    np.savetxt(tmp_path / 'KITTI' / 'dataset' / 'poses' / '00.txt',
               np.concatenate([R, pos[:, :, None]], 2).reshape(N_EVAL, 12),
               fmt='%.17g')
    kdir = tmp_path / 'KITTI'
    frames = (_drain(tkitti.kitti_image_stream, kdir, '00', 1, 0),
              _drain(root_kitti.kitti_image_stream, kdir, '00', 1, 0))
    truth = (tuple(zip(tkitti.load_kitti_gt(kdir, '00'),
                       root_kitti.load_kitti_gt(kdir, '00'))) +
             ((tkitti.read_calib_file(seqdir / 'calib.txt'),
               root_kitti.read_calib_file(seqdir / 'calib.txt')),))

    def run_ate(cfg):
        poses, tstamps = tkitti.run(cfg, NPZ, kdir, '00', 1, device='cpu')
        pos_gt, quat_gt = tkitti.load_kitti_gt(kdir, '00')
        return tkitti.ate(pos_gt, quat_gt, poses, tstamps, 1)[0]
    return frames, truth, run_ate


def _icl_nuim(tmp_path):
    """ICL-NUIM layout: <scene>/*.png, calib/icl_nuim.txt,
    TrajectoryGT/livingRoom0.gt.freiburg (TUM format, stamps 1..N)."""
    root = tmp_path / 'ICL_NUIM'
    scene = 'living_room_traj0_loop'
    _write_frames(root / scene, [f'{t}.png' for t in range(N_EVAL)])
    pos, q = _gt_wxyz(N_EVAL)
    (root / 'TrajectoryGT').mkdir()
    gtp = root / 'TrajectoryGT' / 'livingRoom0.gt.freiburg'
    np.savetxt(gtp, np.concatenate([np.arange(1, N_EVAL + 1)[:, None], pos,
                                    q[:, [1, 2, 3, 0]]], 1), fmt='%.17g')
    calib = os.path.join(REPO, 'calib', 'icl_nuim.txt')
    frames = (_drain(t_image_stream, str(root / scene), calib, 1, 0),
              _drain(j_image_stream, str(root / scene), calib, 1, 0))
    # the root script's ground-truth path (evaluate_icl_nuim.py:75-81)
    want = root / 'TrajectoryGT' / f'livingRoom{scene[-6]}.gt.freiburg'
    assert ticl.groundtruth_path(root, scene) == want
    assert ticl.groundtruth_path(root, 'office_room_traj2_loop') == \
        root / 'TrajectoryGT' / 'traj2.gt.freiburg'
    truth = ((t_read_tum(ticl.groundtruth_path(root, scene)),
              j_read_tum(want)),)

    def run_ate(cfg):
        poses, _ = ticl.run(cfg, NPZ, root / scene, calib, 1, device='cpu')
        return ticl.ate(t_read_tum(gtp), poses, str(root / scene), 1)[0]
    return frames, truth, run_ate


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    elif hasattr(a, 'positions_xyz'):
        for key in ('positions_xyz', 'orientations_quat_wxyz', 'timestamps'):
            np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    else:
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('layout', [_euroc, _tum, _kitti, _icl_nuim],
                         ids=['euroc', 'tum', 'kitti', 'icl_nuim'])
def test_eval_readers_match_root_and_run(layout, tmp_path, monkeypatch):
    frames, truth, run_ate = layout(tmp_path)
    _assert_same_items(*frames)
    assert frames[0][0][1].shape == (H, W, 3)
    assert len(frames[0]) == N_EVAL + 1
    for got, want in truth:
        _assert_equal(got, want)
    monkeypatch.setattr(tdemo, 'DPVO', _forced(tdemo.DPVO))
    with torch_threads(2):
        err = run_ate(_small_cfg(torch_cfg))
    assert np.isfinite(err), err


def test_evaluate_synthetic_matches_root(monkeypatch):
    default = os.path.join(REPO, 'config', 'default.yaml')
    jc, tc = jax_config.cfg.clone(), torch_cfg.clone()
    jc.merge_from_file(default)
    tc.merge_from_file(default)
    monkeypatch.setattr(jax_config, 'cfg', jc)     # run_vo_ate's base_cfg
    monkeypatch.setattr(tacc, 'base_cfg', tc)      # learned_cfg's
    name, seed = next(iter(tsynthetic.SCENES.items()))
    assert (name, tsynthetic.SCENES) == ('synth_900', root_synthetic.SCENES)
    assert (tsynthetic.T, tsynthetic.H, tsynthetic.W, tsynthetic.STEP) == (
        root_synthetic.T, root_synthetic.H, root_synthetic.W,
        root_synthetic.STEP)
    seq = make_sequence(seed, T=tsynthetic.T, H=tsynthetic.H, W=tsynthetic.W,
                        step=tsynthetic.STEP)
    want = root_synthetic.run_once(seq, NPZ, 1234)
    with torch_threads(2):
        got = tsynthetic.run_once(seq, NPZ, 1234, device='cpu')
    assert np.isfinite(got) and got < 0.5
    assert abs(got - want) <= 1e-3, (got, want)

