"""Entry points for a driver: one frame of the flagship runtime on the card,
and a data-parallel dry run of the training step.

Counterpart of the root __graft_entry__.py. entry() gives (fn, args): one
DeviceVO frame at 640x480 on config/default.yaml (M = 96), past the
bootstrap, with seeded random weights and the motion probe forced, so a
call runs patchify, K1 (the correlation kernel), the update operator and
pair-blocked BA once. dryrun_multichip(n) runs one train step at the JAX
dry run's shapes (B = n, T = 8, M = 2, 32x32, edge_schedule(8, 2, 2), f32)
in n processes over torch.distributed's gloo backend on the CPU, one
sequence per rank, and asserts a finite loss and bit-equal parameters on
every rank.

    python -c "from dpvo_torch import graft_entry as g; g.dryrun_multichip(4)"
"""
import os
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device='cuda'):
    """(fn, args): fn(*args) tracks one 640x480 frame on DeviceVO."""
    from .config import cfg
    from .runtime import DPVO
    c = cfg.clone()
    c.merge_from_file(os.path.join(REPO, 'config', 'default.yaml'))
    H, W = 480, 640
    rng = np.random.RandomState(0)
    tex = rng.randint(0, 255, (H + 64, W + 64, 3)).astype(np.uint8)
    frames = [tex[4 * t:4 * t + H, 4 * t:4 * t + W] for t in range(9)]
    intr = np.asarray([W * 0.73, W * 0.73, W / 2, H / 2], np.float32)
    slam = DPVO(c, None, ht=H, wd=W, seed=0, device=device)
    slam.force_accept = True       # random weights never pass the probe
    for t in range(8):             # the 8th frame runs the bootstrap
        slam(t, frames[t], intr)
    return slam, (8, frames[8], intr)


def dryrun_batch(n):
    """The JAX dry run's batch (__graft_entry__.py:_dryrun_body) for B = n:
    random frames, identity poses, seeded coords and depths."""
    B, T, M, H, W = n, 8, 2, 32, 32
    rng = np.random.RandomState(0)
    return dict(
        images=np.asarray(rng.randint(0, 255, (B, T, H, W, 3)), np.float32),
        poses_gt=np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1.0], np.float32),
                         (B, T, 1)),
        disps=np.asarray(rng.uniform(0.3, 1.5, (B, T, H // 4, W // 4)),
                         np.float32),
        intrinsics=np.tile(np.asarray([30.0, 30.0, W / 8, H / 8],
                                      np.float32), (B, 1)),
        coords=np.asarray(
            np.stack([rng.randint(1, W // 4 - 1, (B, T, M)),
                      rng.randint(1, H // 4 - 1, (B, T, M))], -1),
            np.float32),
        depth_init=np.asarray(rng.uniform(0.2, 1.0, (B, T, M)), np.float32),
    )


class KeepGrads:
    """An optimizer wrapper that keeps a copy of the gradients it steps on
    (the all-reduced ones under data parallelism)."""

    def __init__(self, optimizer, net):
        self.optimizer, self.net, self.grads = optimizer, net, None

    def step(self):
        self.grads = {k: p.grad.detach().clone()
                      for k, p in self.net.named_parameters()
                      if p.grad is not None}
        self.optimizer.step()


def dp_step(net, batch, group=None):
    """One f32 train step of net on batch (this rank's share under a
    group) at the dry run's schedule: (loss, aux, the gradients the
    optimizer stepped on)."""
    from .train.trainer import edge_schedule, make_optimizer, \
        make_train_step
    opt = KeepGrads(make_optimizer(net.parameters(), total_steps=100), net)
    step = make_train_step(net, opt, edge_schedule(8, 2, 2),
                           structure_only=False, mixed_precision=False,
                           group=group)
    loss, aux = step(batch)
    return loss, aux, opt.grads


def _dryrun_rank(rank, n, init_file, out):
    import torch
    import torch.distributed as dist
    from .models.vonet import init_vonet
    from .parallel.mesh import all_gather_cat, shard_batch
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}',
                            rank=rank, world_size=n)
    try:
        net = init_vonet(None, 'cpu')
        loss, _, grads = dp_step(net, shard_batch(dryrun_batch(n), rank, n),
                                 group=dist.group.WORLD)
        flat = torch.cat([p.detach().reshape(-1) for p in net.parameters()])
        every = all_gather_cat(flat[None], dist.group.WORLD)
        assert np.isfinite(float(loss)), f'non-finite loss {float(loss)}'
        assert all(torch.equal(every[0], x) for x in every), \
            'parameters differ across ranks'
        if out is not None:
            np.savez(os.path.join(out, f'rank{rank}.npz'),
                     loss=float(loss),
                     **{'grad/' + k: g.numpy() for k, g in grads.items()},
                     **{'param/' + k: p.detach().numpy()
                        for k, p in net.named_parameters()})
        if rank == 0:
            print(f'dryrun_multichip({n}): loss={float(loss):.4f}, '
                  f'parameters bit-equal on {n} ranks', flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices, out=None):
    """One data-parallel train step in n_devices gloo processes on the CPU
    (torch.multiprocessing.spawn, a file:// rendezvous). With out, each
    rank also writes out/rank<r>.npz: its loss, the all-reduced gradients
    ('grad/<name>') and the parameters after the step ('param/<name>')."""
    import torch.multiprocessing as tmp_mp
    with tempfile.TemporaryDirectory() as tmp:
        tmp_mp.spawn(_dryrun_rank,
                     args=(n_devices, os.path.join(tmp, 'rendezvous'), out),
                     nprocs=n_devices, join=True)
