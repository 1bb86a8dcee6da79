"""The readings the check's limits are set from (limits/<config>.json):
the program's numbers on many seeds (the lower readings) and the
control's on a few (the upper readings), at a cell's own sizes.

    python3 -m portbench.calibrate --workload dpvo-default.clients \
        --seeds 101-112 --control 101-103 --out cal.json

One process on the card, one client at a time (the numbers compared do
not depend on how many clients share the card): for each seed a client as
the benchmark builds it, its bootstrap and warm-up, then frames up to its
checked frame; then the check against the reference, and on the control
seeds the control (the reference in float8 e4m3, check.Judge) in the
program's place. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import spec


def seed_list(text):
    out = []
    for part in text.split(','):
        a, _, b = part.partition('-')
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog='python3 -m portbench.calibrate')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=seed_list, required=True)
    p.add_argument('--control', type=seed_list, default=[])
    p.add_argument('--out', required=True)
    p.add_argument('--device', default='cuda:0')
    a = p.parse_args(argv)
    import torch
    from .check import Judge, judge, limits_of
    from .client import Client
    cell, config, traffic, _ = spec.resolve(spec.benchmark(), a.workload)
    band = limits_of(config['name'])['keyframe_band']
    rows = []
    for k, seed in enumerate(a.seeds):
        t0 = time.monotonic()
        c = Client(dict(config=config, traffic=traffic, seed=seed,
                        index=k % traffic['clients'], trace=0,
                        device=a.device))
        c.warm_up()
        for t in range(c.warm, c.rec.step_frame + 1):
            c.track(t)
        c.sync()
        j = Judge(config, c.seq, c.seeds['weights'], c.seeds['vo'], c.dev)
        row = dict(seed=seed, program=judge(j, c.rec, band=band))
        if seed in a.control:
            row['control'] = judge(j, c.rec, control=True, band=band)
        row['seconds'] = time.monotonic() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del c, j
        if a.device.startswith('cuda'):
            torch.cuda.empty_cache()
    names = sorted(rows[0]['program'])
    lim = limits_of(config['name'])['numbers']
    summary = {}
    for n in names:
        lo = max(r['program'][n] for r in rows)
        ctl = [r['control'][n] for r in rows if 'control' in r]
        summary[n] = dict(lower=lo, upper=min(ctl) if ctl else None,
                          limit=lim.get(n))
        print(f'{n}: program max {lo!r} over {len(rows)} seeds; control '
              f'min {summary[n]["upper"]!r}; limit {lim.get(n)!r}',
              flush=True)
    with open(a.out, 'w') as f:
        kind = torch.cuda.get_device_name(0) if a.device.startswith(
            'cuda') else a.device
        json.dump(dict(workload=a.workload, rows=rows, summary=summary,
                       device=kind), f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
