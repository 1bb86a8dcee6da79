"""The kernels on the planes ring against other builds of their sources, on
the card: K5 (planes_roll), K8 (planes_w12x16, planes_fixedw) and K2
(ops/corr_fused.planes on bf16 maps), all csrc/planes_ring.cuh:ring_body.

    python -m dpvo_torch.scripts.ring_sweep [--against DIR] [--sweep]
                                            [--out FILE]

--against DIR compiles DIR/corr_probes.cu and DIR/corr_fused.cu (the csrc
directory of another checkout, its headers beside them, e.g. the parent
commit's unpacked with `git archive`) and times each kernel of this
checkout against its counterpart there, in turns both ways round
(_common.time_paired: device time of back-to-back launches): K5 and K4 on
micro_fused_v2's inputs (K5 also with zero rolls, which wrap no row
run), K8 (both) and K7 on micro_kernel_variants', K2 on chip_smoke.py's
phase-3 inputs (E = 49,152) and on micro_fused_v2's. K4 and K7 are not
on the ring: their ratios show the spread of the measurement.
--sweep compiles copies of this checkout's csrc with other rings for the
probes (corr_probes.cu:ProbeRing, SWEEP) and times each against the
checkout's build in turns; their outputs must equal the checkout's bit for
bit (the ring changes no sum).
Both print ptxas's register and spill lines of the kernels compared and
the card's name and power limit; --out writes every row as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from dpvo_torch.ops import corr_fused, cuda_lib
from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import _common as cm
from dpvo_torch.scripts import micro_fused_v2, micro_kernel_variants

BUILD = cuda_lib.BUILD_DIR / 'ring_sweep'
# the probes' rings of each sweep variant, (stages, window positions per
# stage, consumer warps, blocks per SM): K5 (448 positions per edge) and
# K8 (384, both instantiations)
SWEEP = [((3, 64, 4, 4), (3, 64, 4, 4)),
         ((3, 64, 1, 4), (3, 64, 1, 4)),
         ((3, 64, 2, 3), (3, 64, 2, 3)),
         ((2, 64, 2, 5), (2, 64, 2, 5)),
         ((2, 64, 4, 5), (2, 64, 4, 5)),
         ((4, 64, 4, 3), (4, 64, 4, 3)),
         ((6, 32, 1, 4), (6, 32, 1, 4)),
         ((6, 32, 2, 4), (6, 32, 2, 4)),
         ((4, 32, 2, 5), (4, 32, 2, 5)),
         ((2, 112, 2, 3), (2, 96, 2, 4)),
         ((2, 112, 7, 3), (2, 96, 6, 4)),
         ((3, 112, 2, 2), (2, 128, 2, 3)),
         ((3, 112, 7, 2), (2, 128, 8, 3))]


def with_ring(src, key, ring):
    """corr_probes.cu's source `src` with ProbeRing of `key` set to
    `ring`."""
    pat = (r'(struct ProbeRing<\w+> \{  // ' + key + r'\s*static constexpr '
           r'int )kStages = \d+, kRows = \d+, kWarps = \d+, '
           r'kBlocksPerSm = \d+;')
    rep = (r'\g<1>kStages = {}, kRows = {}, kWarps = {}, '
           r'kBlocksPerSm = {};').format(*ring)
    out, n = re.subn(pat, rep, src)
    if n != 1:
        raise RuntimeError(f'ProbeRing of {key} not found')
    return out


def compile_lib(csrc, name, tag):
    """csrc/<name>.cu (its headers beside it) built into BUILD/<tag>;
    returns the .so path."""
    so = BUILD / tag / f'lib{name}.so'
    cuda_lib.compile_source(Path(csrc) / f'{name}.cu', so)
    return so


def variant_csrc(rings):
    """A copy of this checkout's csrc with the probes' rings `rings`
    ((K5 ring, K8 ring)) in BUILD/src_<tag>; returns (directory, tag)."""
    tag = '_'.join('x'.join(map(str, r)) for r in rings)
    out = BUILD / f'src_{tag}'
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out)
    src = (out / 'corr_probes.cu').read_text()
    src = with_ring(src, 'planes_roll', rings[0])
    for key in ('planes_w12x16', 'planes_fixedw'):
        src = with_ring(src, key, rings[1])
    (out / 'corr_probes.cu').write_text(src)
    return out, tag


def load(so, signatures):
    return cuda_lib.bind(ctypes.CDLL(str(so)), signatures)


def ptxas(so, names):
    """{kernel: its ptxas lines of spills and registers} from the log
    beside `so`, for the entry functions whose mangled name holds one of
    `names`."""
    out, cur = {}, None
    for line in so.with_suffix('.log').read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
        elif cur and ('spill' in line or 'registers' in line):
            out[cur] = (out.get(cur, '') + ' ' + line.strip()).strip()
    return out


def on(mod, lib, fn):
    """fn with module `mod` launching from library `lib`."""
    def call():
        mod._lib = lib
        return fn()
    return call


def calls(dev):
    """[(name, ring key or None, module, fn)] of every kernel compared, on
    its inputs; the ring key names the probe's ring (PLANES_RING)."""
    v2 = micro_fused_v2.inputs(dev)
    a5, (sh1, sh2), E5 = v2['args'], v2['sh'], v2['E']
    a8 = micro_kernel_variants.inputs(dev)['args']
    from chip_smoke import corr_case     # phase 3's inputs
    gmap, f1, f2, co, kk, jj = corr_case(49152, 36, 120, 160, 36 * 96, 2)
    g, f1, f2 = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
                 for a in (gmap, f1, f2))
    co, kk, jj = (torch.from_numpy(a).to(dev) for a in (co, kk, jj))
    w1 = corr_fused.window_base(co, 120, 160, 8)
    w2 = corr_fused.window_base(co / 4.0, 30, 40, 4)
    k2 = (g.reshape(-1, 9, 128), f1, f2, kk, jj, w1[4], w1[5], w2[4], w2[5])
    k2_v2 = (a5[0], a5[1], a5[2],
             torch.arange(E5, dtype=torch.int32, device=dev), *a5[3:])
    zero = torch.zeros_like(sh1)
    return [
        ('planes_roll (K5)', 'planes_roll', cp,
         lambda: cp.planes_roll(*a5, sh1, sh2)),
        ('planes_roll (K5, zero rolls)', 'planes_roll', cp,
         lambda: cp.planes_roll(*a5, zero, zero)),
        ('planes_w12x16 (K8)', 'planes_w12x16', cp,
         lambda: cp.planes_w12x16(*a8)),
        ('planes_fixedw (K8)', 'planes_fixedw', cp,
         lambda: cp.planes_fixedw(*a8[:4])),
        ('planes_pair (K4)', None, cp, lambda: cp.planes_pair(*a5)),
        ('planes_first49 (K7)', None, cp, lambda: cp.planes_first49(*a8)),
        ('corr_planes (K2, phase 3)', None, corr_fused,
         lambda: corr_fused.planes(*k2)),
        ('corr_planes (K2, K4 inputs)', None, corr_fused,
         lambda: corr_fused.planes(*k2_v2)),
    ]


def paired_both(mod, new, old, fn):
    """fn from library `new` against `old` in turns, both ways round
    (new first, then old first): {'new_ms', 'old_ms', 'ratio' (new /
    old, the geometric mean of both orders), 'ratios'}."""
    a, b, r1 = cm.time_paired(on(mod, new, fn), on(mod, old, fn))
    c, d, r2 = cm.time_paired(on(mod, old, fn), on(mod, new, fn))
    ratio = (a / b * d / c) ** 0.5
    return dict(new_ms=(a + d) / 2, old_ms=(b + c) / 2, ratio=ratio,
                ratios=r1 + [1 / r for r in r2])


def against(dev, csrc, rows):
    """This checkout's kernels against DIR's in turns (module
    docstring)."""
    names = ('probe_planes', 'corr_planes_ring')
    with ThreadPoolExecutor(2) as ex:
        sos = list(ex.map(lambda n: compile_lib(csrc, n, 'against'),
                          ('corr_probes', 'corr_fused')))
    old = {cp: load(sos[0], cp.SIGNATURES),
           corr_fused: load(sos[1], corr_fused.SIGNATURES)}
    new = {cp: cp._lib, corr_fused: corr_fused._lib}
    for tag, libs in (('this checkout', (cp.build(), corr_fused.build())),
                      (str(csrc), sos)):
        for so in libs:
            for k, v in ptxas(Path(so), names).items():
                print(f'  ptxas ({tag}) {k}: {v}', flush=True)
    for name, _, mod, fn in calls(dev):
        got, ref = on(mod, new[mod], fn)(), on(mod, old[mod], fn)()
        err, scale, ok = cm.compare(got, ref)
        if not ok:
            raise RuntimeError(f'{name}: this build vs {csrc} off the bound '
                               f'({err} at {scale})')
        row = paired_both(mod, new[mod], old[mod], fn)
        row.update(name=name, max_abs_diff=err)
        rows.append(row)
        print(f'  {name}: this checkout {row["new_ms"]!r} ms, {csrc} '
              f'{row["old_ms"]!r} ms, ratio {row["ratio"]!r} (rounds '
              f'{min(row["ratios"])!r} .. {max(row["ratios"])!r}); '
              f'max|diff| {err!r}', flush=True)
        mod._lib = new[mod]
        del got, ref
    torch.cuda.empty_cache()


def sweep(dev, rows):
    """The probes' rings of SWEEP against this checkout's in turns."""
    cp.build()
    base = cp._lib
    srcs = [variant_csrc(r) for r in SWEEP]
    with ThreadPoolExecutor(len(srcs)) as ex:   # one nvcc per variant
        sos = list(ex.map(lambda s: compile_lib(s[0], 'corr_probes', s[1]),
                          srcs))
    todo = [c for c in calls(dev) if c[1] is not None]
    for rings, so in zip(SWEEP, sos):
        lib = load(so, cp.SIGNATURES)
        for k, v in ptxas(so, ('probe_planes_ring',)).items():
            print(f'  ptxas {rings}: {k}: {v}', flush=True)
        for name, key, _, fn in todo:
            ring = rings[0] if key == 'planes_roll' else rings[1]
            ref = on(cp, base, fn)()
            got = on(cp, lib, fn)()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise RuntimeError(f'{name} ring {ring}: output differs')
            del got, ref
            ms, base_ms, ratios = cm.time_paired(on(cp, lib, fn),
                                                 on(cp, base, fn))
            rows.append(dict(name=name, ring=ring, ms=ms, base_ms=base_ms,
                             ratio=ms / base_ms, ratios=ratios,
                             base_ring=cp.PLANES_RING[key]))
            print(f'  {name} ring {ring}: {ms!r} ms against '
                  f'{cp.PLANES_RING[key]} {base_ms!r} ms, ratio '
                  f'{ms / base_ms!r} (rounds {min(ratios)!r} .. '
                  f'{max(ratios)!r})', flush=True)
        cp._lib = base
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--against', type=Path)
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--out', type=Path)
    a = ap.parse_args()
    dev = cm.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'ring_sweep on {smi}', flush=True)
    rows = {'card': smi, 'against': [], 'sweep': []}
    cp.build()
    corr_fused.build()
    if a.against:
        against(dev, a.against, rows['against'])
    if a.sweep:
        sweep(dev, rows['sweep'])
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rows, indent=1))


if __name__ == '__main__':
    main()
