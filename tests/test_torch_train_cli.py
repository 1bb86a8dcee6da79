"""The training entry point (dpvo_torch/train/cli.py), the port of the root
train.py, on the CPU:

- prefetch_batches: the first batch equals the root script's on the same
  seeded generator and datasets (its later batches race: its thread and
  main loop share one RandomState); an error of the reader is raised in
  the consumer, not left to hang it;
- main(--device cpu) on test_data_readers.py:make_scene's TartanAir layout
  (crop cut to 48x64, n_frames 8, M = 2; the first steps of the 240,000
  step schedule): two structure-only steps from
  the seeded init, a checkpoint in dpvo_tpu's .npz layout, and --validate
  calling evaluate_tartan.evaluate on it; then --ckpt from that file on
  --dataset synthetic: full steps (the pose loss's aux); --validate whose
  evaluation fails raises; --device cuda without a GPU raises.
"""
import argparse

import numpy as np
import pytest

from dpvo_torch.data_readers import factory as tfactory
from dpvo_torch.data_readers import synthetic as tsyn
from dpvo_torch.models.checkpoint import load_network
from dpvo_torch.train import cli
from dpvo_tpu.data_readers import synthetic as jsyn
from test_data_readers import make_scene
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def test_first_prefetched_batch_matches_root():
    import train as root_train
    args = argparse.Namespace(batch=2, patches_per_frame=4)
    dbs = (tsyn.Synthetic(n_scenes=5, n_frames=4, H=24, W=32),
           jsyn.Synthetic(n_scenes=5, n_frames=4, H=24, W=32))
    ours = cli.prefetch_batches(dbs[0], args, np.random.RandomState(9))
    got = next(ours)
    ref = next(root_train.prefetch_batches(dbs[1], args,
                                           np.random.RandomState(9)))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got['images'].shape == (2, 4, 24, 32, 3)
    assert got['disps'].shape == (2, 4, 6, 8)
    assert got['coords'].shape == (2, 4, 4, 2)
    ours.close()                       # stops the thread


def test_prefetch_raises_the_readers_error():
    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise ValueError('unreadable frame')

    args = argparse.Namespace(batch=1, patches_per_frame=2)
    batches = cli.prefetch_batches(Broken(), args, np.random.RandomState(0))
    with pytest.raises(RuntimeError, match='prefetch') as e:
        next(batches)
    assert isinstance(e.value.__cause__, ValueError)


def _small_factory(monkeypatch, tmp_path):
    """dataset_factory as main calls it, with the TartanAir crop and the
    synthetic frames cut to 48x64 and the scene info pickled in tmp_path."""
    real = tfactory.dataset_factory

    def small(names, **kw):
        if names == ['tartan']:
            kw.update(crop_size=(48, 64),
                      scene_info_path=str(tmp_path / 'tartan.pickle'))
        else:
            kw.update(H=48, W=64, n_scenes=4)
        return real(names, **kw)
    monkeypatch.setattr(tfactory, 'dataset_factory', small)


def _args(**kw):
    argv = ['--steps', '240000', '--n_frames', '8', '--patches_per_frame',
            '2', '--device', 'cpu', '--name', 'tiny']
    for k, v in kw.items():
        argv += [f'--{k}'] if v is True else [f'--{k}', str(v)]
    return cli.parser().parse_args(argv)


def test_main_trains_validates_and_resumes(tmp_path, monkeypatch):
    make_scene(tmp_path / 'TartanAir')
    _small_factory(monkeypatch, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, 'SAVE_EVERY', 2)
    from dpvo_torch import evaluate_tartan
    calls = []

    def fake_evaluate(config, net, **kw):
        calls.append((config, net, kw))
        return {'AUC': 0.5, 'AVG': 0.25}
    monkeypatch.setattr(evaluate_tartan, 'evaluate', fake_evaluate)

    hist = cli.main(_args(validate=True, dataset='tartan',
                          datapath=tmp_path / 'TartanAir'), n_steps=2)
    assert len(hist) == 2
    assert all(set(h) == {'loss'} and np.isfinite(h['loss'])
               for h in hist), hist                     # structure-only
    ckpt = tmp_path / 'checkpoints' / 'tiny_000002.npz'
    assert ckpt.is_file() and (tmp_path / 'runs' / 'tiny').is_dir()
    assert calls == [(None, 'checkpoints/tiny_000002.npz',
                      dict(split='validation', trials=1, device='cpu'))]
    assert len(load_network(str(ckpt))) > 50

    # resumed from the port's checkpoint: the full (pose) steps
    hist = cli.main(_args(ckpt=ckpt, dataset='synthetic'), n_steps=1)
    assert len(hist) == 1 and {'loss', 'tr', 'ro'} == set(hist[0])
    assert all(np.isfinite(v) for v in hist[0].values())


def test_failed_validation_raises(tmp_path, monkeypatch):
    _small_factory(monkeypatch, tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, 'SAVE_EVERY', 1)
    from dpvo_torch import evaluate_tartan

    def failing(*a, **k):
        raise FileNotFoundError('datasets/TartanAir/... missing')
    monkeypatch.setattr(evaluate_tartan, 'evaluate', failing)
    with pytest.raises(FileNotFoundError):
        cli.main(_args(validate=True, dataset='synthetic'), n_steps=3)


def test_cuda_without_a_gpu_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = _args(dataset='synthetic')
    args.device = 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(args, n_steps=1)
