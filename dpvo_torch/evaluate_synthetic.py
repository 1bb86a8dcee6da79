"""Synthetic-scene evaluation: the in-repo regression protocol (the port of
the root evaluate_synthetic.py).

    python -m dpvo_torch.evaluate_synthetic --trials 3 \
        --network artifacts/micro_vonet.npz

No dataset exists in the repo, so this runs the reference's result-log
protocol (N trials per sequence, per-scene sorted ATEs, median, AVG --
evaluate_tartan.py:129-146) over rendered exact-GT sequences
(data_readers/synthetic.py, scenes 900-904) and writes
logs/synthetic_{trained,random}_<stamp>.txt in the same format. Each trial
is accuracy.learned_ate, the settings of the root protocol's
scripts/train_synthetic.py:run_vo_ate (accuracy.learned_cfg over the
merged --config). --network none records the random-weights floor;
--device (default cuda) is added.
"""
import argparse
import datetime
from pathlib import Path

import numpy as np

from .accuracy import learned_ate
from .config import cfg
from .data_readers.synthetic import make_sequence
from .demo import require_device

SCENES = {f'synth_{s:03d}': s for s in (900, 901, 902, 903, 904)}
T, H, W, STEP = 30, 64, 96, 0.12


def run_once(seq, network, seed, device='cuda'):
    err, _path = learned_ate(network, seq, device=device, seed=seed)
    return err


def main(argv=None):
    """Run the protocol; returns ({scene: sorted ATEs}, AVG of medians)."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--network', default='artifacts/micro_vonet.npz')
    ap.add_argument('--trials', type=int, default=3)
    ap.add_argument('--config', default='config/default.yaml')
    ap.add_argument('--opts', nargs='+', default=[])
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    require_device(args.device)
    cfg.merge_from_file(args.config)
    if args.opts:
        cfg.merge_from_list(args.opts)
    network = None if args.network in ('none', 'None', '') else args.network

    results = {}
    for name, seed in SCENES.items():
        seq = make_sequence(seed, T=T, H=H, W=W, step=STEP)
        results[name] = sorted(
            run_once(seq, network, 1234 + i, args.device)
            for i in range(args.trials))
        print(f'{name}: {results[name]}')

    meds = {k: float(np.median(v)) for k, v in results.items()}
    avg = float(np.mean(list(meds.values())))
    Path('logs').mkdir(exist_ok=True)
    stamp = datetime.datetime.now().strftime('%m-%d-%H-%M')
    tag = 'trained' if network else 'random'
    out = Path('logs') / f'synthetic_{tag}_{stamp}.txt'
    with open(out, 'w') as f:
        for k, v in results.items():
            f.write(f'{k}: {[round(x, 4) for x in v]} '
                    f'median {meds[k]:.4f}\n')
        f.write(f'AVG: {avg:.5f}\n')
    print(f'AVG: {avg:.5f}  -> {out}')
    return results, avg


if __name__ == '__main__':
    main()
