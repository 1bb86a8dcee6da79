"""Build (or find built) the configuration's CUDA libraries, without
PyTorch: the program's builder, dpvo_torch/ops/cuda_lib.py, loaded from
its file (the package's own import would load PyTorch). A run starts this
first, so that nvcc runs while the clients start.

    python3 -m portbench.build corr_onepass [...]
"""
from __future__ import annotations

import importlib.util
import sys
import time

from .spec import ROOT


def load_cuda_lib():
    path = ROOT / 'dpvo_torch' / 'ops' / 'cuda_lib.py'
    s = importlib.util.spec_from_file_location('portbench_cuda_lib', path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def main(argv=None):
    names = sys.argv[1:] if argv is None else argv
    t0 = time.monotonic()
    cuda_lib = load_cuda_lib()
    for name in names:
        cuda_lib.load(name)
    print(f'libraries {names} ready in {time.monotonic() - t0:.3f} s',
          file=sys.stderr, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
