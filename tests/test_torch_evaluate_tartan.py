"""dpvo_torch.evaluate_tartan against the root evaluate_tartan.py, on the CPU,
on a one-scene TartanAir layout written to tmp_path (test_torch_eval_cli's
N_EVAL = 10 frames of 70x100, cropped by the protocol to 64x96; a NED
pose_left.txt):

- video_iterator: the same frames, crops and intrinsics;
- evaluate(split='validation') with both packages' test_split patched to
  the one scene, artifacts/micro_vonet.npz, a small config (M = 8, f32)
  and each package's DPVO wrapped to force the motion probe: the same
  result keys, every value within 1e-3 of the root's;
- the protocol alone: with both packages' run patched to return the same
  trajectories, two scenes and two trials, evaluate gives the root's
  results to 1e-12 and the root's plot files;
- evaluate raises without a GPU when asked for cuda.
"""
import os

import cv2
import numpy as np
import pytest

import evaluate_tartan as root_et
from dpvo_torch import evaluate_tartan as tet
from dpvo_torch.config import cfg as torch_cfg
from dpvo_torch.data_readers import tartan as ttartan
from dpvo_tpu.config import cfg as jax_cfg
from dpvo_tpu.data_readers import tartan as jtartan
from test_torch_cli import _forced, _small_cfg, _texture_frames
from test_torch_eval_cli import N_EVAL as N
from test_torch_runtime import NPZ, torch_threads

SCENE = 'abandonedfactory/abandonedfactory/Easy/P011'


def _layout(root):
    scene = root / 'datasets' / 'TartanAir' / SCENE
    (scene / 'image_left').mkdir(parents=True)
    for t, img in enumerate(_texture_frames(N, H=70, W=100)):
        cv2.imwrite(str(scene / 'image_left' / f'{t:06d}_left.png'), img)
    t = np.arange(N)
    # NED rows: x forward, y right, z down; the protocol permutes to xyz
    ned = np.stack([0.02 * t, 0.03 * t, 0.01 * np.sin(t), 0 * t, 0 * t,
                    0 * t, 1 + 0 * t], 1)
    np.savetxt(scene / 'pose_left.txt', ned, delimiter=' ')
    return scene


def test_video_iterator_matches_root(tmp_path):
    scene = _layout(tmp_path)
    got = list(tet.video_iterator(str(scene / 'image_left')))
    ref = list(root_et.video_iterator(str(scene / 'image_left')))
    assert len(got) == len(ref) == N
    for (t, img, intr), (tr, imgr, intrr) in zip(got, ref):
        assert t == tr and img.shape == (64, 96, 3)
        np.testing.assert_array_equal(img, imgr)
        np.testing.assert_array_equal(intr, intrr)


def test_evaluate_matches_root(tmp_path, monkeypatch):
    _layout(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jtartan, 'test_split', [SCENE])
    monkeypatch.setattr(ttartan, 'test_split', [SCENE])
    monkeypatch.setattr(root_et, 'DPVO', _forced(root_et.DPVO))
    monkeypatch.setattr(tet, 'DPVO', _forced(tet.DPVO))
    ref = root_et.evaluate(_small_cfg(jax_cfg), NPZ, split='validation',
                           trials=1)
    with torch_threads(2):
        got = tet.evaluate(_small_cfg(torch_cfg), NPZ, split='validation',
                           trials=1, device='cpu')
    assert list(got) == list(ref) == [f'Tartan/{SCENE}', 'AUC', 'AVG']
    for k in ref:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-3,
                                   err_msg=k)
    assert got['AVG'] > 0


def test_protocol_matches_root(tmp_path, monkeypatch):
    scenes = [SCENE, 'ocean/ocean/Hard/P009']
    rng = np.random.RandomState(4)
    trajs = {}

    def fake_run(imagedir, cfg, network, viz=False, seed=1234, **kw):
        key = (imagedir, seed)
        if key not in trajs:
            p = np.cumsum(rng.randn(N, 3) * 0.05, 0)
            q = rng.randn(N, 4) * 0.05 + [0, 0, 0, 1]
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            trajs[key] = (np.concatenate([p, q], 1), np.arange(N) * 1.0)
        return trajs[key]
    for scene in scenes:
        d = tmp_path / 'datasets' / 'TartanAir' / scene
        d.mkdir(parents=True)
        gt = np.concatenate([np.cumsum(rng.randn(N, 3) * 0.05, 0),
                             np.tile([0, 0, 0, 1.0], (N, 1))], 1)
        np.savetxt(d / 'pose_left.txt', gt, delimiter=' ')
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jtartan, 'test_split', scenes)
    monkeypatch.setattr(ttartan, 'test_split', scenes)
    monkeypatch.setattr(root_et, 'run', fake_run)
    monkeypatch.setattr(tet, 'run', fake_run)
    ref = root_et.evaluate(_small_cfg(jax_cfg), NPZ, trials=2, plot=True)
    plots = sorted(p.name for p in (tmp_path / 'trajectory_plots').iterdir())
    for p in (tmp_path / 'trajectory_plots').iterdir():
        p.unlink()
    got = tet.evaluate(_small_cfg(torch_cfg), NPZ, trials=2, plot=True,
                       device='cpu')
    assert list(got) == list(ref) and len(got) == 4
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, err_msg=k)
    assert sorted(p.name for p in
                  (tmp_path / 'trajectory_plots').iterdir()) == plots
    assert len(plots) == 4


def test_evaluate_on_cuda_without_a_gpu_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tet.evaluate(None, NPZ, device='cuda')
    assert os.path.isfile(tet.DEFAULT_CONFIG)
