"""Build and load the port's hand-written CUDA kernels.

Each source `dpvo_torch/csrc/<name>.cu` is compiled with nvcc for sm_90a on
first use into build/dpvo_torch_kernels/lib<name>_<hash>.so (one library
per hash of the source, every csrc/*.cuh header and the flags; the
compiler's output, with the ptxas register / spill lines, is kept beside it
as a .log file) and loaded with ctypes. Nothing is built at import: the CPU
paths never need nvcc. Sources build independently, so callers may build
several at once from threads (nvcc runs as a subprocess).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'dpvo_torch_kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_loaded = {}     # source name -> (ctypes.CDLL, path of the .so)


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    path = shutil.which('nvcc') or os.path.join(cuda_home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(f'nvcc not found (looked on PATH and at {path})')
    return path


def source_hash(source):
    """12 hex digits of the sha1 of `source`, every csrc/*.cuh (a source
    may include any of them) and the nvcc flags."""
    h = hashlib.sha1(source.read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def compile_source(source, so):
    """nvcc `source` (its headers beside it) into the shared library `so`,
    the compiler's output beside it as a .log file. The library appears
    atomically: concurrent processes agree on one file."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} '
                           f'({proc.returncode}):\n{proc.stdout}\n'
                           f'{proc.stderr}')
    so.with_suffix('.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)


def load(name):
    """Compile csrc/<name>.cu (once per hash of it, the headers and the
    flags) and load it; later calls return the loaded library at once.
    Returns (CDLL, .so path)."""
    if name in _loaded:
        return _loaded[name]
    source = CSRC / f'{name}.cu'
    so = BUILD_DIR / f'lib{name}_{source_hash(source)}.so'
    if not so.exists():
        compile_source(source, so)
    _loaded[name] = (ctypes.CDLL(str(so)), so)
    return _loaded[name]


def bind(lib, signatures):
    """Sets the argument types (and an int result) of each C entry of
    `signatures` ({name: [ctypes types]}) that `lib` exports; returns
    lib."""
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib
