"""Resolve a workload of BENCHMARK.json into the data files it names.

Everything that belongs to one configuration, traffic mix, span or
per-layer metric sits in a file of its own under this package, found by
the name BENCHMARK.json gives it.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(Path(root) / 'BENCHMARK.json')


def resolve(bench, workload, here=HERE):
    """(cell entry, configuration, traffic mix, the cell's metrics:
    {'end_to_end': [...], 'per_layer': [...]}) of the named workload.
    Raises KeyError / FileNotFoundError for a name that resolves to
    nothing."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json '
                       f'(have {sorted(cells)})')
    cell = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    config = load_json(here.parent / configs[cell['config']]['file'])
    traffic = load_json(here / 'traffic' / f"{cell['traffic']}.json")

    def mine(m):
        return workload in m.get('workloads', [workload])

    metrics = {k: [m for m in bench[k] if mine(m)]
               for k in ('end_to_end', 'per_layer')}
    return cell, config, traffic, metrics


def spans(here=HERE):
    """{name: spec} of every span file: spec['target'] is
    'module:attr.path' of the function the span wraps; 'kernel' (optional)
    a substring of the kernel names the span's roofline times; 'bound'
    (optional) the module under bounds/ that states its least time."""
    return {p.stem: load_json(p) for p in sorted((here / 'spans').glob(
        '*.json'))}


# top-level modules a run may not load: JAX and the JAX package the port
# was made from (compared by the part of a module's name before its first
# dot, whole: dpvo_torch is not dpvo_tpu)
FORBIDDEN = frozenset({'jax', 'jaxlib', 'flax', 'dpvo_tpu'})


def readers(here=HERE):
    """{metric name: module file} of every per-layer reader."""
    return {p.stem: p for p in sorted((here / 'metrics').glob('*.py'))
            if not p.stem.startswith('_')}
