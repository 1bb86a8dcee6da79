"""One-pass planes with and without the per-row input streams, on the card
(K7).

    python -m dpvo_torch.scripts.micro_onepass_dma [--scale S] [--seed N]

Counterpart of scripts/micro_onepass_dma.py (STREAMS=0 and 1). At scale 1
its sizes: E = 49,152 edges, 36 frames of 120x160 / 30x40 bf16 maps (edges
on the first 22, sorted), K2's 12x24 / 10x16 windows at the script's
bases, f32 out: the first 49 columns of each level's flattened plane row,
(E * 9, 49) per level. The streams variant also reads per-row s1, s2
(int32) and fr1, fr2 (f32 pairs) and the blocks S1 (168, 49), S2 (112, 49)
(seeded random here, zeros in the script): its output must equal the plain
variant's exactly. Where the CUDA toolkit has cuobjdump, the global loads
(LDG) of both compiled variants are counted. Each variant is held against
its plain version; times are CUDA-event medians of 20 (the card only).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess

import numpy as np
import torch

from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import _common as cm

H1, W1 = 120, 160
H2, W2 = H1 // 4, W1 // 4
F0 = 36
E0 = 49152
JJ_MAX = 22            # the script's edges use frames 0 .. 21
TY, TX = 10, 16        # the script's slab offsets: bases below are image ones
C, P2 = cm.C, cp.P2
SCRIPT = 'scripts/micro_onepass_dma.py'


def sass_loads(so):
    """Global loads (LDG) of the two first-49 instantiations in the shared
    library `so`, from `cuobjdump -sass`: {'planes_first49': n,
    'planes_first49_streams': n}, or None where cuobjdump is missing."""
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME') or '/usr/local/cuda', 'bin', 'cuobjdump')
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, '-sass', str(so)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    # probe_planes<12, 24, 10, 16, kFirst49, kStreams, false>
    want = {'ILi12ELi24ELi10ELi16ELi2ELb0ELb0E': 'planes_first49',
            'ILi12ELi24ELi10ELi16ELi2ELb1ELb0E': 'planes_first49_streams'}
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r'Function : (\S+)', line)
        if m:
            name = next((v for k, v in want.items() if k in m.group(1)), None)
            if name:
                counts[name] = 0
        elif name and re.search(r'\bLDG\b', line):
            counts[name] += 1
    return counts


def main(device='cuda', scale=1.0, seed=0):
    """Runs both variants against their plain versions; returns {'E', 'F',
    'variants': {name: row}, 'streams_equal', 'sass_ldg'}."""
    dev = cm.device(device)
    E = cm.scaled(E0, scale, 32)
    F = max(2, round(F0 * scale))
    rng = np.random.default_rng(seed)
    g9 = cm.normal(rng, (E, P2, C), dev)
    fmap1 = cm.normal(rng, (F, H1, W1, C), dev)
    fmap2 = cm.normal(rng, (F, H2, W2, C), dev)
    jj = cm.ints(np.sort(rng.integers(0, min(JJ_MAX, F), E)), dev)
    by1 = cm.ints(rng.integers(0, 100, E) - TY, dev)
    bx1 = cm.ints(rng.integers(0, 20, E) * 8 - TX, dev)
    by2 = cm.ints(rng.integers(0, 30, E) - TY, dev)
    ph2 = rng.integers(0, 2, E)
    bx2 = cm.ints(rng.integers(0, 8, E) * 8 - TX + 4 * ph2, dev)
    R = E * P2
    streams = (cm.ints(rng.integers(-2 ** 31, 2 ** 31, (R, 1)), dev),
               cm.normal(rng, (R, 2), dev, torch.float32),
               cm.ints(rng.integers(-2 ** 31, 2 ** 31, (R, 1)), dev),
               cm.normal(rng, (R, 2), dev, torch.float32),
               cm.normal(rng, (7 * cp.WX, cp.FIRST), dev, torch.float32),
               cm.normal(rng, (7 * cp.WX2, cp.FIRST), dev, torch.float32))
    print(f'micro_onepass_dma: E = {E}, F = {F}, maps {H1}x{W1} / {H2}x{W2}',
          flush=True)

    args = (g9, fmap1, fmap2, jj, by1, bx1, by2, bx2)
    n = cp.FIRST
    nb = (cm.nbytes(g9, jj, by1, bx1, by2, bx2) + 2 * R * n * 4 +
          cm.map_bytes(jj, *cm.window_yx(by1, bx1, cp.WX, n), F, H1, W1) +
          cm.map_bytes(jj, *cm.window_yx(by2, bx2, cp.WX2, n), F, H2, W2))
    flops = 2 * E * P2 * 2 * n * C
    rows = {}
    rows['planes_first49'] = cm.run(
        'planes_first49 (K7, STREAMS=0)', 'planes_first49', f'{SCRIPT}:28',
        lambda: cp.planes_first49(*args),
        lambda: cp.planes_first49_plain(*args), nb, flops, dev)
    rows['planes_first49_streams'] = cm.run(
        'planes_first49 (K7, STREAMS=1)', 'planes_first49_streams',
        f'{SCRIPT}:28', lambda: cp.planes_first49(*args, streams=streams),
        lambda: cp.planes_first49_plain(*args),
        nb + cm.nbytes(*streams) + E * 4, flops, dev)

    a = cp.planes_first49(*args)
    b = cp.planes_first49(*args, streams=streams)
    equal = all(torch.equal(x, y) for x, y in zip(a, b))
    if not equal:
        raise RuntimeError('planes_first49: the streams changed the output')
    ldg, note = None, 'no kernels (CPU run)'
    if dev.type == 'cuda':
        ldg = sass_loads(cp.build())
        note = 'cuobjdump not found' if ldg is None else ldg
    print(f'  STREAMS=1 output equals STREAMS=0: {equal}; global loads in '
          f'the compiled kernels (cuobjdump -sass): {note}', flush=True)
    return dict(E=E, F=F, variants=rows, streams_equal=equal, sass_ldg=ldg)


if __name__ == '__main__':
    cm.cli(main, __doc__)
