"""Data-parallel training over torch.distributed, one process per card.

Counterpart of dpvo_tpu/parallel/mesh.py, which builds a 'dp' mesh for
GSPMD: the batch shards over the mesh and XLA inserts the one gradient
all-reduce. Here each process (rank) takes its slice of the global batch
(shard_batch), runs its sequences' forward and backward, and the train
step (train/trainer.py:make_train_step(..., group=...)) sums the gradients
over the ranks with one flattened all-reduce (all_reduce_grads) before the
optimizer's clip, so clip and AdamW run on the same numbers on every rank
and the parameters stay equal.

    torchrun --nproc_per_node=N -m dpvo_torch.train.cli ...

init_from_env() reads torchrun's RANK / WORLD_SIZE / LOCAL_RANK (and
MASTER_ADDR / MASTER_PORT through the env:// rendezvous) and starts the
process group: nccl for a CUDA device, gloo for the CPU.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_from_env(device='cuda'):
    """(rank, world, device, group). Without torchrun's WORLD_SIZE in the
    environment: (0, 1, device, None), no process group. With it: the
    process group is started (nccl where `device` is CUDA, gloo on the
    CPU; each rank on card LOCAL_RANK) and group is the world group."""
    dev = torch.device(device)
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1, dev, None
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    if dev.type == 'cuda':
        dev = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group('nccl' if dev.type == 'cuda' else 'gloo',
                                init_method='env://', rank=rank,
                                world_size=world)
    return rank, world, dev, dist.group.WORLD


def shard_batch(batch, rank, world):
    """This rank's contiguous slice of every array's leading (batch) axis:
    rows [rank * B / world, (rank + 1) * B / world)."""
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        assert B % world == 0, 'batch must divide device count'
        n = B // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def all_reduce_grads(params, group):
    """Sum every parameter's .grad over the group's ranks, in one
    flattened all-reduce (a missing gradient counts as zeros)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    off = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def all_gather_cat(x, group):
    """Every rank's x (equal shapes), concatenated along dim 0 in rank
    order."""
    world = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
