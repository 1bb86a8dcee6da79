"""Training entry point: the port of the root train.py (reference train.py
parity), on TartanAir or the synthetic scenes.

    python -m dpvo_torch.train.cli --dataset tartan --datapath DIR
    torchrun --nproc_per_node=N -m dpvo_torch.train.cli --batch N ...

The root script's flags, plus --device (default cuda; cpu runs on the
CPU). Under torchrun each process trains on one card (parallel/mesh.py):
every rank draws the same global batch of --batch sequences and trains on
its slice, the step sums the gradients over the ranks before the clip,
and rank 0 alone logs and writes checkpoints. Weights load from --ckpt
(.pth or .npz) or start from init_vonet_params(0); the first 1,000 steps
without --ckpt are structure-only; every SAVE_EVERY steps rank 0 writes
checkpoints/<name>_<step>.npz in dpvo_tpu's layout and, with --validate,
runs evaluate_tartan on the validation split.

Two faults of the root script are not copied: its prefetch thread and main
loop draw from one RandomState, so after the first batch the draws depend
on thread timing (here the prefetch thread has its own generator), and its
--validate catches every error and prints a warning (here it raises).
"""
import argparse
import queue
import threading
from pathlib import Path

import numpy as np

SAVE_EVERY = 10000


def prefetch_batches(db, args, rng):
    """Host batches, assembled in a thread from its own generator `rng`
    (a np.random.RandomState) in the root script's draw order: per batch
    the --batch sequence indices, then the patch coordinates (x, then y),
    then the depth seeds. Yields dicts of images (B, T, H, W, 3),
    poses_c2w (B, T, 7), disps at 1/4 (B, T, H/4, W/4), intrinsics (B, 4),
    coords (B, T, M, 2), depth_init (B, T, M), all f32. An error of the
    reader is raised here; closing the generator stops the thread."""
    q = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass

    def worker():
        try:
            produce()
        except BaseException as e:           # handed to the consumer
            put(e)

    def produce():
        while not stop.is_set():
            seqs = [db[rng.randint(len(db))] for _ in range(args.batch)]
            images = np.stack([s[0] for s in seqs])          # (B,T,H,W,3)
            poses = np.stack([s[1] for s in seqs])           # c2w
            disps = np.stack([s[2] for s in seqs])
            intr = np.stack([s[3][0] for s in seqs])         # (B,4)
            B, T, H, W, _ = images.shape
            M = args.patches_per_frame
            coords = np.stack([
                rng.randint(1, W // 4 - 1, (B, T, M)),
                rng.randint(1, H // 4 - 1, (B, T, M))], axis=-1)
            # disps at feature resolution (reference net.py:193: [1::4, 1::4])
            disps4 = disps[:, :, 1::4, 1::4]
            item = dict(images=images.astype(np.float32),
                        poses_c2w=poses.astype(np.float32),
                        disps=disps4.astype(np.float32),
                        intrinsics=intr.astype(np.float32),
                        coords=coords.astype(np.float32),
                        depth_init=rng.rand(B, T, M).astype(np.float32))
            put(item)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise RuntimeError('the batch prefetch thread failed') \
                    from item
            yield item
    finally:
        stop.set()
        thread.join()


def main(args, n_steps=None):
    """Train for args.steps steps, or the first n_steps of that schedule
    (the one-cycle rate needs --steps >= 100); returns the list of
    per-step metrics (the global batch's mean loss and aux means)."""
    import torch

    from ..data_readers.factory import dataset_factory
    from ..demo import require_device
    from ..logger import Logger
    from ..models.checkpoint import save_params_npz
    from ..models.vonet import init_vonet
    from ..parallel import mesh
    from ..runtime import numpy_se3 as nse3
    from .trainer import edge_schedule, make_optimizer, make_train_step

    require_device(args.device)
    rank, world, dev, group = mesh.init_from_env(args.device)
    assert args.batch % world == 0, 'batch must divide device count'
    if world > 1 and rank == 0:
        print(f'Data-parallel training over {world} processes')

    data_rng = np.random.RandomState(1234)       # the prefetch thread's
    step_rng = np.random.RandomState(1235)       # the per-sequence keys

    db = dataset_factory([args.dataset], datapath=args.datapath,
                         n_frames=args.n_frames)
    net = init_vonet(args.ckpt, dev)
    optimizer = make_optimizer(net.parameters(), lr=args.lr,
                               total_steps=args.steps, clip=args.clip)

    logger = Logger(args.name) if rank == 0 else None
    steps_warm = edge_schedule(args.n_frames, args.patches_per_frame, 18)
    step_so = make_train_step(net, optimizer, steps_warm,
                              structure_only=True, group=group)
    step_full = make_train_step(net, optimizer, steps_warm,
                                structure_only=False, group=group)

    history = []
    total_steps = 0
    batches = prefetch_batches(db, args, data_rng)
    try:
        for batch in batches:
            # world-to-camera (reference train.py:81: SE3(poses).inv())
            batch['poses_gt'] = nse3.inv(batch.pop('poses_c2w'))
            # per-sequence keys: corr-gradient dropout + random edge
            # removal in the unroll (reference net.py:161-172, 239-244)
            B = batch['images'].shape[0]
            batch['rng'] = step_rng.randint(0, 2**31 - 1,
                                            (B, 2)).astype(np.uint32)
            so = total_steps < 1000 and args.ckpt is None
            step = step_so if so else step_full
            loss, aux = step(mesh.shard_batch(batch, rank, world))

            metrics = {'loss': float(loss)}
            for k, v in aux.items():
                metrics[k] = float(v.float().mean())
            history.append(metrics)
            if logger is not None:
                logger.push(metrics)

            total_steps += 1
            if total_steps % SAVE_EVERY == 0 and rank == 0:
                Path('checkpoints').mkdir(exist_ok=True)
                ckpt_path = f'checkpoints/{args.name}_{total_steps:06d}.npz'
                save_params_npz(net.state_dict(), ckpt_path)
                # in-training validation (reference train.py:144-156)
                if args.validate:
                    from .. import evaluate_tartan
                    val = evaluate_tartan.evaluate(
                        None, ckpt_path, split='validation', trials=1,
                        device=str(dev))
                    logger.write_dict({f'val/{k}': v
                                       for k, v in val.items()})
                    print(f'[val @ {total_steps}] {val}')
            if total_steps >= (n_steps or args.steps):
                break
    finally:
        batches.close()
        if logger is not None:
            logger.close()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
    return history


def parser():
    p = argparse.ArgumentParser()
    p.add_argument('--name', default='bla', help='name your experiment')
    p.add_argument('--ckpt', help='checkpoint to restore')
    p.add_argument('--steps', type=int, default=240000)
    p.add_argument('--lr', type=float, default=0.00008)
    p.add_argument('--clip', type=float, default=10.0)
    p.add_argument('--n_frames', type=int, default=15)
    p.add_argument('--batch', type=int, default=1)
    p.add_argument('--patches_per_frame', type=int, default=80)
    p.add_argument('--pose_weight', type=float, default=10.0)
    p.add_argument('--flow_weight', type=float, default=0.1)
    p.add_argument('--datapath', default='datasets/TartanAir')
    p.add_argument('--dataset', default='tartan',
                   choices=['tartan', 'synthetic'],
                   help="'synthetic' trains on rendered exact-GT scenes (no "
                        "dataset download needed)")
    p.add_argument('--validate', action='store_true',
                   help='run evaluate_tartan on the validation split at '
                        'every checkpoint (reference train.py:151)')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (each torchrun rank takes card LOCAL_RANK) "
                        "or 'cpu'")
    return p


if __name__ == '__main__':
    main(parser().parse_args())
