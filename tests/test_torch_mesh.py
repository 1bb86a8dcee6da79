"""Data-parallel training (dpvo_torch/parallel/mesh.py and
train/trainer.py:make_train_step(..., group=...)) on the CPU, over
torch.distributed's gloo backend:

- shard_batch gives each rank its contiguous slice and refuses a batch
  the ranks do not divide;
- init_from_env: no process group without torchrun's variables; with
  WORLD_SIZE = 1 a gloo group, over which all_reduce_grads is the
  identity;
- graft_entry.dryrun_multichip(4): one train step at the JAX dry run's
  shapes (B = 4, T = 8, M = 2, 32x32, f32) in 4 gloo processes
  (torch.multiprocessing.spawn, file:// rendezvous), one sequence each:
  every rank's all-reduced gradients within 1e-5 relative L2 per tensor
  of the one-process step on the same batch (test_torch_trainer.py holds
  that step to dpvo_tpu), the same global loss, and the parameters after
  the step bit-equal across ranks (and within 1e-6 of the one-process
  step's).
"""
import socket

import numpy as np
import pytest
import torch

from dpvo_torch import graft_entry
from dpvo_torch.models.vonet import init_vonet
from dpvo_torch.parallel import mesh
from test_torch_runtime import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures('one_torch_thread')


def test_shard_batch():
    batch = dict(a=np.arange(8).reshape(4, 2), b=torch.arange(4))
    parts = [mesh.shard_batch(batch, r, 2) for r in range(2)]
    np.testing.assert_array_equal(parts[0]['a'], [[0, 1], [2, 3]])
    np.testing.assert_array_equal(parts[1]['a'], [[4, 5], [6, 7]])
    assert parts[1]['b'].tolist() == [2, 3]
    assert mesh.shard_batch(batch, 0, 1)['a'] is not None
    with pytest.raises(AssertionError, match='divide'):
        mesh.shard_batch(batch, 0, 3)


def test_init_from_env_and_one_rank_all_reduce(monkeypatch):
    for k in ('WORLD_SIZE', 'RANK', 'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_from_env('cpu') == (0, 1, torch.device('cpu'), None)
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    monkeypatch.setenv('WORLD_SIZE', '1')
    monkeypatch.setenv('RANK', '0')
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    monkeypatch.setenv('MASTER_PORT', str(port))
    rank, world, dev, group = mesh.init_from_env('cpu')
    try:
        assert (rank, world, dev.type) == (0, 1, 'cpu')
        assert torch.distributed.get_backend(group) == 'gloo'
        p = [torch.nn.Parameter(torch.randn(3, 2)),
             torch.nn.Parameter(torch.randn(5))]
        p[0].grad = torch.randn(3, 2)
        before = p[0].grad.clone()
        mesh.all_reduce_grads(p, group)
        assert torch.equal(p[0].grad, before)
        assert torch.equal(p[1].grad, torch.zeros(5))
        x = torch.arange(6.0).reshape(2, 3)
        assert torch.equal(mesh.all_gather_cat(x, group), x)
    finally:
        torch.distributed.destroy_process_group()


def test_dp_step_matches_one_process(tmp_path):
    graft_entry.dryrun_multichip(4, out=str(tmp_path))
    net = init_vonet(None, 'cpu')
    loss, _, grads = graft_entry.dp_step(net, graft_entry.dryrun_batch(4))
    params = {k: p.detach().numpy() for k, p in net.named_parameters()}
    ranks = [dict(np.load(tmp_path / f'rank{r}.npz')) for r in range(4)]
    assert np.isfinite(float(loss))
    held = 0
    for z in ranks:
        np.testing.assert_allclose(float(z['loss']), float(loss), rtol=1e-6)
        assert sorted(k[5:] for k in z if k.startswith('grad/')) == \
            sorted(grads)
        for k, ref in grads.items():
            ref = ref.numpy()
            n = np.linalg.norm(ref)
            err = np.linalg.norm(z['grad/' + k] - ref)
            assert err <= 1e-5 * n, (k, err, n)
            held += n > 0
        for k in params:
            np.testing.assert_array_equal(z['param/' + k],
                                          ranks[0]['param/' + k])
            np.testing.assert_allclose(z['param/' + k], params[k],
                                       rtol=0, atol=1e-6)
    assert held > 0.8 * 4 * len(grads)
