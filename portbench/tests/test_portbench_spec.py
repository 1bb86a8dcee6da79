"""BENCHMARK.json and the data files it names: every workload resolves,
names and units keep to their characters, and a cell made of new files
alone resolves."""
from __future__ import annotations

import json
import shutil

import pytest

from portbench import spec


def test_every_workload_resolves_to_its_files():
    b = spec.benchmark()
    for w in b['workloads']:
        cell, config, traffic, metrics = spec.resolve(b, w['name'])
        assert config['name'] == cell['config']
        assert traffic['name'] == cell['traffic']
        assert traffic['clients'] >= 1
        assert metrics['end_to_end'] and metrics['per_layer']
        assert (spec.HERE / 'limits' / f"{config['name']}.json").exists()
        for m in metrics['end_to_end'] + metrics['per_layer']:
            assert m['name'] in spec.readers(), m['name']


def test_names_units_and_keys_keep_to_the_contract():
    b = spec.benchmark()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    names = [c['name'] for c in b['configs']] + \
        [w['name'] for w in b['workloads']] + \
        [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in b['workloads']]:
        assert spec.NAME.match(n), n
    for m in b['end_to_end'] + b['per_layer']:
        assert spec.UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for m in b['per_layer']:
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/')
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] in (1, 4) and len(w['why']) <= 200
    setup = [m for m in b['end_to_end'] if m['name'] == 'setup_s']
    assert setup and setup[0]['bound'] <= 0.25


def test_spans_name_targets_and_bounds_that_exist():
    import importlib
    for name, s in spec.spans().items():
        assert spec.NAME.match(name)
        assert ':' in s['target']
        if 'bound' in s:
            mod = importlib.import_module(f'portbench.bounds.{s["bound"]}')
            assert callable(mod.capture) and callable(mod.seconds)


def test_a_cell_of_new_files_alone_resolves(tmp_path):
    here = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns(
        '__pycache__', 'tests'))
    b = spec.benchmark()
    base = json.loads((here / 'configs' / 'dpvo-default.json').read_text())
    fast = dict(base, name='dpvo-fast', dpvo=dict(
        base['dpvo'], PATCHES_PER_FRAME=48, REMOVAL_WINDOW=16,
        OPTIMIZATION_WINDOW=7, PATCH_LIFETIME=11))
    (here / 'configs' / 'dpvo-fast.json').write_text(json.dumps(fast))
    (here / 'traffic' / 'burst.json').write_text(json.dumps(
        dict(json.loads((here / 'traffic' / 'clients.json').read_text()),
             name='burst', clients=5)))
    (here / 'metrics' / 'frames_total.py').write_text(
        'def read(facts):\n    return facts["frames"]\n')
    b['configs'].append(dict(name='dpvo-fast', source='test',
                             file='portbench/configs/dpvo-fast.json',
                             reduced=[], why='test'))
    b['workloads'].append(dict(name='dpvo-fast.burst', config='dpvo-fast',
                               traffic='burst', chips=1, why='test'))
    b['per_layer'].append(dict(name='frames_total', unit='frames',
                               better='higher', source='host_clock',
                               layer='driver', moves='fps',
                               workloads=['dpvo-fast.burst']))
    cell, config, traffic, metrics = spec.resolve(b, 'dpvo-fast.burst',
                                                  here=here)
    assert traffic['name'] == 'burst' and traffic['clients'] == 5
    assert config['dpvo']['PATCHES_PER_FRAME'] == 48
    assert 'frames_total' in [m['name'] for m in metrics['per_layer']]
    assert 'frames_total' in spec.readers(here)
    with pytest.raises(KeyError):
        spec.resolve(b, 'dpvo-fast.nothing', here=here)
