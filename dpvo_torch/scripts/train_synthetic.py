"""Train a micro-VONet on synthetic scenes with the port, and certify it.

    python -m dpvo_torch.scripts.train_synthetic --steps 2000

The port's entry point for scripts/train_synthetic.py, with the same flags
and phases:
  1. trains VONet with dpvo_torch/train/trainer.py's step (f32, on the card
    by default) on rendered slanted-plane scenes with exact ground truth
    (data_readers/synthetic.py): --structure-steps with poses held at the
    truth, then --noise-steps of the pose curriculum (the first window
    starts at noisy ground truth, the noise ramping up to --noise-max),
    then full steps from the identity;
  2. every --val-every steps runs the full DeviceVO runtime with the
    weights on validation sequences and keeps the best;
  3. evaluates trained against seeded random weights on held-out sequences
    in DeviceVO (dpvo_torch/accuracy.py:learned_ate) and, to show that the
    saved .npz loads in both runtimes, in HybridVO;
  4. writes <out>/micro_vonet.npz (dpvo_tpu's layout: its load_params_npz
    reads it) and <out>/synthetic_ate.json.
The default --out is under build/, which git ignores: the committed
artifacts/micro_vonet.npz is never overwritten by accident.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_batch_pool(n_seqs, T, H, W, step, seed0=100, loop_frac=0.0):
    """Rendered training scenes; loop_frac > 0 renders that share with
    out-and-back trajectories (direction reversals)."""
    from dpvo_torch.data_readers.synthetic import make_sequence
    every = max(int(round(1.0 / loop_frac)), 1) if loop_frac > 0 else 0
    return [make_sequence(seed0 + i, T=T, H=H, W=W, step=step,
                          loop=bool(every and i % every == 1))
            for i in range(n_seqs)]


def hybrid_ate(network, seq, *, device, seed=7):
    """learned_ate's run in HybridVO (the same config, the motion probe
    forced): (ATE, path length)."""
    from dpvo_torch.accuracy import learned_cfg, path_length, trajectory_ate
    from dpvo_torch.runtime import HybridVO
    images = seq['images']
    T, H, W, _ = images.shape
    slam = HybridVO(learned_cfg(), network, ht=H, wd=W, seed=seed,
                    device=device)
    slam.motion_probe = lambda: 100.0
    for t in range(T):
        slam(t, images[t], seq['intrinsics'])
    poses, tstamps = slam.terminate()
    return trajectory_ate(poses, tstamps, seq['wfc']), path_length(seq['wfc'])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=2000)
    ap.add_argument('--structure-steps', type=int, default=400)
    ap.add_argument('--noise-steps', type=int, default=0,
                    help='pose-curriculum phase length after the structure '
                    'phase: the first window starts at noisy ground truth, '
                    'the noise ramping 0 -> --noise-max')
    ap.add_argument('--noise-max', type=float, default=0.35)
    ap.add_argument('--loop-frac', type=float, default=0.0,
                    help='share of training scenes rendered with '
                    'out-and-back trajectories')
    ap.add_argument('--lr', type=float, default=3e-4)
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--pool', type=int, default=32)
    ap.add_argument('--T', type=int, default=15)
    ap.add_argument('--M', type=int, default=8)
    ap.add_argument('--H', type=int, default=64)
    ap.add_argument('--W', type=int, default=96)
    ap.add_argument('--unroll', type=int, default=14)
    ap.add_argument('--motion-step', type=float, default=0.12)
    ap.add_argument('--val-every', type=int, default=500,
                    help='run the full-runtime ATE on validation scenes '
                    'every K steps and keep the best weights')
    ap.add_argument('--val-seeds', type=int, nargs='+', default=[800, 801])
    ap.add_argument('--out', default=os.path.join('build', 'train_synthetic'))
    ap.add_argument('--resume', default=None,
                    help='continue from a saved .npz instead of fresh init')
    ap.add_argument('--eval-only', action='store_true')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args()

    import torch
    from dpvo_torch.accuracy import learned_ate
    from dpvo_torch.data_readers.synthetic import (make_batch_from,
                                                   make_sequence)
    from dpvo_torch.models.checkpoint import save_params_npz
    from dpvo_torch.models.vonet import init_vonet
    from dpvo_torch.runtime import numpy_se3 as nse3
    from dpvo_torch.train.trainer import (edge_schedule, make_optimizer,
                                          make_train_step)

    dev = torch.device(args.device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device (pass --device cpu)')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    npz_path = os.path.join(args.out, 'micro_vonet.npz')
    json_path = os.path.join(args.out, 'synthetic_ate.json')
    results = {}

    if not args.eval_only:
        print(f'[train] device={dev} pool={args.pool} B={args.batch} '
              f'T={args.T} M={args.M} {args.H}x{args.W} '
              f'unroll={args.unroll}', flush=True)
        t0 = time.time()
        seqs = build_batch_pool(args.pool, args.T, args.H, args.W,
                                args.motion_step, loop_frac=args.loop_frac)
        print(f'[train] rendered {args.pool} seqs in {time.time() - t0:.1f}s',
              flush=True)

        sched = edge_schedule(args.T, args.M, args.unroll)
        net = init_vonet(args.resume, dev)
        opt = make_optimizer(net.parameters(), lr=args.lr,
                             total_steps=args.steps)
        step_so = make_train_step(net, opt, sched, structure_only=True,
                                  mixed_precision=False)
        step_full = make_train_step(net, opt, sched, structure_only=False,
                                    mixed_precision=False)

        val_seqs = [make_sequence(s, T=30, H=args.H, W=args.W,
                                  step=args.motion_step)
                    for s in args.val_seeds]
        if args.loop_frac > 0:
            # selection must see the reversal regime too
            val_seqs.append(make_sequence(820, T=40, H=args.H, W=args.W,
                                          step=args.motion_step, loop=True))
        tmp_npz = npz_path + '.tmp.npz'

        def val_ate():
            save_params_npz(net.state_dict(), tmp_npz)
            ates = [learned_ate(tmp_npz, sq, device=dev)[0]
                    for sq in val_seqs]
            print('[val]   per-seq: ' + ' '.join(f'{a:.4f}' for a in ates),
                  flush=True)
            return float(np.mean(ates))

        best = (np.inf, -1)
        rng = np.random.RandomState(0)
        s1 = args.structure_steps
        s2 = s1 + args.noise_steps
        step_s = []
        t0 = time.time()
        for it in range(args.steps):
            idx = rng.choice(len(seqs), args.batch, replace=False)
            batch = make_batch_from([seqs[i] for i in idx], rng, args.M)
            if s1 <= it < s2:
                # pose curriculum: first-window init = GT * exp(noise), the
                # rotation at half the translation's scale
                sig = args.noise_max * (it - s1 + 1) / max(s2 - s1, 1)
                gt = batch['poses_gt']                      # (B, T, 7) w2c
                B, T = gt.shape[:2]
                xi = rng.randn(B, T, 6).astype(np.float32) * sig
                xi[..., 3:] *= 0.5
                batch['gs_init'] = nse3.mul(
                    gt.reshape(-1, 7),
                    nse3.exp(xi.reshape(-1, 6))).reshape(B, T, 7)
            ts = time.perf_counter()
            fn = step_so if it < s1 else step_full
            loss, aux = fn(batch)
            loss = float(loss)           # the step's end, on the host
            step_s.append(time.perf_counter() - ts)
            if it % 50 == 0 or it == args.steps - 1:
                ax = {k: float(v.mean()) for k, v in aux.items()}
                print(f'[train] it={it:5d} loss={loss:9.4f} '
                      + ' '.join(f'{k}={v:.4f}' for k, v in sorted(ax.items()))
                      + f' ({time.time() - t0:.0f}s)', flush=True)
            last = it == args.steps - 1
            if args.val_every and it >= s1 and (
                    (it - s1) % args.val_every == 0 or last):
                v = val_ate()
                if v < best[0]:
                    best = (v, it)
                    save_params_npz(net.state_dict(), npz_path)
                print(f'[val] it={it:5d} ate={v:.4f} '
                      f'best={best[0]:.4f}@{best[1]}', flush=True)
        if not np.isfinite(best[0]):    # validation off: keep final weights
            save_params_npz(net.state_dict(), npz_path)
        if os.path.exists(tmp_npz):
            os.remove(tmp_npz)
        results['train_s'] = time.time() - t0
        results['step_s_median'] = float(np.median(step_s)) if step_s \
            else None
        results['best_val'] = [float(best[0]), int(best[1])]
        print(f'[train] saved {npz_path} (best val ATE {best[0]:.4f} at '
              f'it={best[1]}); median step {results["step_s_median"]} s',
              flush=True)

    # ---- held-out evaluation: trained vs random weights ----
    for name, net_path in (('trained', npz_path), ('random', None)):
        errs, paths = [], []
        for seed in (900, 901):
            seq = make_sequence(seed, T=30, H=args.H, W=args.W,
                                step=args.motion_step)
            e, p = learned_ate(net_path, seq, device=dev)
            errs.append(e)
            paths.append(p)
            print(f'[eval] {name} seed={seed}: ATE {e:.4f} (path {p:.2f})',
                  flush=True)
        results[f'ate_{name}'] = errs
        results['path_len'] = paths
    seq = make_sequence(900, T=30, H=args.H, W=args.W, step=args.motion_step)
    results['ate_trained_hybrid'] = hybrid_ate(npz_path, seq, device=dev)[0]
    print(f'[eval] trained, HybridVO, seed=900: ATE '
          f'{results["ate_trained_hybrid"]:.4f}', flush=True)

    results['ate_trained_mean'] = float(np.mean(results['ate_trained']))
    results['ate_random_mean'] = float(np.mean(results['ate_random']))
    results['steps'] = args.steps
    results['device'] = (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                         else 'cpu')
    results['config'] = {k: v for k, v in vars(args).items()
                         if k not in ('out', 'resume', 'eval_only')}
    with open(json_path, 'w') as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == '__main__':
    main()
