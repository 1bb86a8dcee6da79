"""Nothing a run loads is JAX or the JAX package, and the reference
imports nothing of the program."""
from __future__ import annotations

import subprocess
import sys

from portbench import spec

ROOT = str(spec.ROOT)


def loaded(code):
    out = subprocess.run([sys.executable, '-c', code + (
        '\nimport sys, json\n'
        'print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))')],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={'PATH': '/usr/bin:/bin', 'HOME': '/nonexistent',
             'PYTHONPATH': ROOT})
    import json
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_dpvo_tpu():
    mods = loaded('import portbench.run, portbench.client, portbench.check, '
                  'portbench.build, '
                  'portbench.calibrate, portbench.trace\n'
                  'import dpvo_torch.runtime, dpvo_torch.models.vonet, '
                  'dpvo_torch.ops.cuda_lib\n'
                  'from portbench.client import Spans\n'
                  'from portbench import spec\n'
                  'Spans(spec.spans())\n'
                  'import runpy\n'
                  'for p in spec.readers().values(): runpy.run_path(str(p))')
    assert not mods & spec.FORBIDDEN, mods & spec.FORBIDDEN
    assert 'dpvo_torch' in mods


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded('import portbench.check, portbench.reference.vo, '
                  'portbench.reference.books, portbench.flops, '
                  'portbench.weights, portbench.traffic')
    assert 'dpvo_torch' not in mods
    assert not mods & spec.FORBIDDEN


def test_the_parent_builds_the_libraries_without_pytorch():
    mods = loaded('import portbench.build\n'
                  'lib = portbench.build.load_cuda_lib()\n'
                  'assert callable(lib.load)')
    assert 'torch' not in mods and 'dpvo_torch' not in mods
