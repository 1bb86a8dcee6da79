"""The probes K4, K6 slab and K7 and the kernels on the planes ring against
other builds of their sources, on the card: K4 (planes_pair, target
tiles), K6 slab (slab, target tiles over by-sorted edges), K7
(planes_first49, both variants), K5 (planes_roll), K8 (planes_w12x16,
planes_fixedw) and K2 (ops/corr_fused.planes on bf16 maps); K2, K5, K7 and
K8 run csrc/planes_ring.cuh:ring_body.

    python -m dpvo_torch.scripts.ring_sweep [--against DIR] [--sweep]
                                            [--ablate] [--only KEY ...]
                                            [--out FILE]

--against DIR compiles DIR/corr_probes.cu and DIR/corr_fused.cu (the csrc
directory of another checkout, its headers beside them, e.g. the parent
commit's unpacked with `git archive`) and times each kernel of this
checkout against its counterpart there, in turns both ways round
(_common.time_paired: device time of back-to-back launches): K4 and K5 on
micro_fused_v2's inputs (K5 also with zero rolls, which wrap no row run),
K6 slab on micro_corr_floor's, K7 (both) on micro_onepass_dma's, K8 (both)
on micro_kernel_variants', K2 on chip_smoke.py's phase-3 inputs (E =
49,152) and on micro_fused_v2's.
--sweep compiles copies of this checkout's csrc with other settings
(SWEEP: K7's ring, corr_probes.cu:ProbeRing; K4's tiles, PairTile; the
slab's tile, SlabTile) and times each kernel they change against the
checkout's build in turns; their outputs must equal the checkout's bit
for bit (no setting changes a sum).
--ablate builds copies with parts of K4's tile kernels, of K7's ring or of
the slab's tile kernel taken out (ABLATIONS: the global stores, the mma,
the copies into shared memory, and their unions; PARTS has each edit) and
times each against the checkout's build in turns, as the sweep does;
their outputs are wrong by design and are not compared.
--only KEY (a key of corr_probes.launches, or 'corr_planes' for K2; may
repeat) keeps the kernels, sweep settings and ablations of those wrappers
only. Each prints ptxas's register and spill lines of the kernels
compared and the card's name and power limit; --out writes every row as
JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
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
from dpvo_torch.scripts import (micro_corr_floor, micro_fused_v2,
                                micro_kernel_variants, micro_onepass_dma)

BUILD = cuda_lib.BUILD_DIR / 'ring_sweep'
# the settings of each sweep variant: 'ring', K7's ring (stages, window
# positions per stage, consumer warps, blocks per SM) for both variants;
# 'tile', {level: K4's tile (map rows, consumer warps, blocks per SM, tile
# pairs per unit)}; 'slab', the slab's tile (map rows, edges per item,
# consumer warps, blocks per SM, tile rows per unit, m16 tiles per unit at
# most and per pass)
SWEEP = [dict(ring=(3, 64, 2, 4)),        # the ring of K5 and K8
         dict(ring=(3, 64, 4, 4)),
         dict(ring=(2, 64, 2, 5)),
         dict(ring=(2, 64, 4, 5)),
         dict(ring=(1, 128, 4, 4)),        # one stage: one chunk per edge
         dict(ring=(2, 128, 2, 3)),
         dict(tile={1: (15, 4, 2, 6)}),     # TY1 = 4
         dict(tile={1: (15, 4, 2, 18)}),
         dict(tile={1: (15, 8, 2, 9)}),
         dict(tile={1: (19, 8, 1, 9)}),     # TY1 = 8
         dict(tile={1: (23, 8, 1, 9)}),     # TY1 = 12
         dict(tile={2: (30, 8, 1, 5)}),
         dict(tile={2: (30, 4, 1, 10)}),
         dict(tile={2: (19, 4, 2, 10)}),    # 4 row bins of a 30-row map
         dict(tile={2: (19, 8, 2, 5)}),
         dict(slab=(32, 32, 8, 1, 2, 12, 2)),   # TY = 17, 1 block per SM
         dict(slab=(20, 64, 8, 1, 2, 12, 2)),   # TY = 5, 64 edges
         dict(slab=(18, 16, 4, 2, 2, 12, 2)),
         dict(slab=(18, 16, 5, 2, 1, 12, 2)),   # one row per unit
         dict(slab=(18, 16, 5, 2, 2, 12, 1)),   # 4 chains per pass
         dict(slab=(18, 16, 5, 2, 2, 8, 2)),
         dict(slab=(18, 16, 5, 2, 2, 16, 2)),
         dict(slab=(17, 16, 5, 2, 2, 12, 2)),   # TY = 2
         dict(slab=(19, 16, 5, 2, 2, 12, 2))]   # TY = 4
FIRST49 = cp.FIRST49

# the parts of a kernel an ablation takes out: (file in csrc, text, the
# text that replaces it). Stores stay in the code behind a test that never
# passes (on a product for K4 and the slab, on the map's height for K7), so
# the products stay live; mma is replaced by B's words, so the B loads stay
# (K4, K7: the A fragment's loads go with it; the slab: A's and B's words
# xor-folded, so that both stay); each copy into shared memory (map rows;
# the slab's g rows too) moves one 256-byte row, so the bytes go and the
# copies' issue and barriers stay.
_MMA_OUT = ('{d}[0] = __uint_as_float(b[0].x);\n{i}{d}[1] = '
            '__uint_as_float(b[1].y);\n{i}{d}[2] = __uint_as_float(b[2].z);'
            '\n{i}{d}[3] = __uint_as_float(b[3].w);')
PARTS = {
    'k4 stores': [
        ('corr_probes.cu', '      *reinterpret_cast<uint32_t*>(orow + q) =',
         '      if (d[0] == 1.2345e-38f)\n'
         '      *reinterpret_cast<uint32_t*>(orow + q) ='),
        ('corr_probes.cu',
         '      if (g0)\n        *reinterpret_cast<uint32_t*>(orow8 + q) =',
         '      if (g0 && d[0] == 1.2345e-38f)\n'
         '        *reinterpret_cast<uint32_t*>(orow8 + q) =')],
    'k4 mma': [('corr_probes.cu', '      tile_mma(g, b, d);\n',
                '      ' + _MMA_OUT.format(d='d', i='      ') + '\n')],
    'k4 copies': [
        ('corr_probes.cu', 'mbar_expect_tx(full, rows * nx * kRowBytes);',
         'mbar_expect_tx(full, rows * kRowBytes);'),
        ('corr_probes.cu', '                  nx * kRowBytes, full);',
         '                  kRowBytes, full);')],
    'k7 stores': [('planes_ring.cuh',
                   '    if (j < n) o[p * K] = wb[p * 16 + j];',
                   '    if (j < n && H1 < 0) o[p * K] = wb[p * 16 + j];')],
    'k7 mma': [('planes_ring.cuh', '        tile_mma(g, b, d0);',
                '        ' + _MMA_OUT.format(d='d0', i='        ')),
               ('planes_ring.cuh', '        tile_mma(g, b, d1);',
                '        ' + _MMA_OUT.format(d='d1', i='        '))],
    'k7 copies': [
        ('planes_ring.cuh', '0xffffffffu, (n > 0 ? n * kRowBytes : 0) +',
         '0xffffffffu, (n > 0 ? kRowBytes : 0) +'),
        ('planes_ring.cuh', '                    run.src + (lo - pa) * kC, '
         'n * kRowBytes, full);', '                    run.src + (lo - pa) '
         '* kC, kRowBytes, full);')],
    'k6 stores': [('corr_probes.cu',
                   '        if (fr < f_stop && q >= 0 && q < kSlab)',
                   '        if (fr < f_stop && q >= 0 && q < kSlab &&\n'
                   '            d[m][0][0][0] == 1.2345e-38f)')],
    'k6 mma': [
        ('corr_probes.cu',
         '            mma_bf16(d[m][r][n], a[m][0][c].x, a[m][1][c].x, '
         'a[m][0][c].y,\n                     a[m][1][c].y, b[r][n][2 * h + '
         'c].x, b[r][n][2 * h + c].y);',
         '            d[m][r][n][0] = __uint_as_float(__float_as_uint(d[m][r]'
         '[n][0]) ^\n                a[m][0][c].x ^ a[m][1][c].x ^ '
         'a[m][0][c].y ^ a[m][1][c].y ^\n                b[r][n][2 * h + '
         'c].x ^ b[r][n][2 * h + c].y);'),
        ('corr_probes.cu',
         '            mma_bf16(d[m][r][n], a[m][0][c].z, a[m][1][c].z, '
         'a[m][0][c].w,\n                     a[m][1][c].w, b[r][n][2 * h + '
         'c].z, b[r][n][2 * h + c].w);',
         '            d[m][r][n][1] = __uint_as_float(__float_as_uint(d[m][r]'
         '[n][1]) ^\n                a[m][0][c].z ^ a[m][1][c].z ^ '
         'a[m][0][c].w ^ a[m][1][c].w ^\n                b[r][n][2 * h + '
         'c].z ^ b[r][n][2 * h + c].w);')],
    'k6 copies': [
        ('corr_probes.cu', 'tiled ? (t.rows * t.nx + ne * kP2) * kRowBytes',
         'tiled ? (t.rows + ne) * kRowBytes'),
        ('corr_probes.cu', '                    t.nx * kRowBytes, full);',
         '                    kRowBytes, full);'),
        ('corr_probes.cu', '(r0.x) * kP2 * kC, kGBytes,',
         '(r0.x) * kP2 * kC, kRowBytes,'),
        ('corr_probes.cu', '(r1.x) * kP2 * kC, kGBytes,',
         '(r1.x) * kP2 * kC, kRowBytes,')],
}
KERNELS = ('k4', 'k7', 'k6')
# the ablations of --ablate: K4's, K7's and the slab's parts, alone and
# together
ABLATIONS = [dict(ablate=(k + ' stores',)) for k in KERNELS] + \
    [dict(ablate=(k + ' mma',)) for k in KERNELS] + \
    [dict(ablate=(k + ' stores', k + ' mma')) for k in KERNELS] + \
    [dict(ablate=(k + ' copies',)) for k in KERNELS] + \
    [dict(ablate=(k + ' stores', k + ' mma', k + ' copies'))
     for k in KERNELS]


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


def with_tile(src, level, tile):
    """The source with PairTile<level> set to `tile`."""
    pat = (r'(struct PairTile<' + str(level) + r'> \{  // planes_pair level '
           r'\d\s*static constexpr int )kRows = \d+, kWarps = \d+, '
           r'kBlocksPerSm = \d+, kUnit = \d+;')
    rep = (r'\g<1>kRows = {}, kWarps = {}, kBlocksPerSm = {}, '
           r'kUnit = {};').format(*tile)
    out, n = re.subn(pat, rep, src)
    if n != 1:
        raise RuntimeError(f'PairTile<{level}> not found')
    return out


def with_slab(src, tile):
    """The source with SlabTile set to `tile`."""
    pat = (r'(struct SlabTile \{  // slab\s*static constexpr int )kRows = '
           r'\d+, kCap = \d+, kWarps = \d+, kBlocksPerSm = \d+,(\s*)'
           r'kUnitRows = \d+, kUnit = \d+, kPass = \d+;')
    rep = (r'\g<1>kRows = {}, kCap = {}, kWarps = {}, kBlocksPerSm = {},'
           r'\g<2>kUnitRows = {}, kUnit = {}, kPass = {};').format(*tile)
    out, n = re.subn(pat, rep, src)
    if n != 1:
        raise RuntimeError('SlabTile not found')
    return out


def with_parts(csrc, names):
    """Takes the parts `names` (keys of PARTS) out of the sources in the
    directory `csrc`, in place."""
    for name in names:
        for file, old, new in PARTS[name]:
            path = Path(csrc) / file
            src = path.read_text()
            if src.count(old) != 1:
                raise RuntimeError(f'{name}: text to edit not found once in '
                                   f'{file}: {old!r}')
            path.write_text(src.replace(old, new))


def changed(variant):
    """The wrappers (keys of corr_probes.launches) whose kernels a sweep
    or ablation variant changes."""
    if 'ablate' in variant:
        return {'k4': ('planes_pair',), 'k6': ('slab',),
                'k7': FIRST49}[variant['ablate'][0][:2]]
    if 'slab' in variant:
        return ('slab',)
    return ('planes_pair',) if 'tile' in variant else FIRST49


def compile_lib(csrc, name, tag):
    """csrc/<name>.cu (its headers beside it) built into BUILD/<tag>;
    returns the .so path."""
    so = BUILD / tag / f'lib{name}.so'
    cuda_lib.compile_source(Path(csrc) / f'{name}.cu', so)
    return so


def variant_csrc(variant):
    """A copy of this checkout's csrc with the settings of `variant` (an
    entry of SWEEP or ABLATIONS) in BUILD/src_<tag>; returns (directory,
    tag)."""
    tag = '_'.join(f'{k}{v}' for k, v in sorted(variant.items()))
    tag = re.sub(r'[^0-9A-Za-z]+', '_', tag).strip('_')
    out = BUILD / f'src_{tag}'
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(cuda_lib.CSRC, out)
    src = (out / 'corr_probes.cu').read_text()
    if 'ring' in variant:
        for key in FIRST49:
            src = with_ring(src, key, variant['ring'])
    for level, tile in variant.get('tile', {}).items():
        src = with_tile(src, level, tile)
    if 'slab' in variant:
        src = with_slab(src, variant['slab'])
    (out / 'corr_probes.cu').write_text(src)
    with_parts(out, variant.get('ablate', ()))
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
    """fn(mod) with module `mod` launching from library `lib`."""
    def call():
        mod._lib = lib
        return fn(mod)
    return call


def module_of(csrc, name):
    """The wrapper module dpvo_torch/ops/<name>.py of the checkout whose
    csrc directory is `csrc`, loaded beside this checkout's (its relative
    imports resolve to this checkout's package), so that each build is
    called through its own wrapper and C signatures."""
    path = Path(csrc).resolve().parent / 'ops' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'dpvo_torch.ops._against_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def calls(dev):
    """[(name, key, module name, fn)] of every kernel compared, on its
    inputs: fn(module) calls the wrapper of `module` (a corr_probes or
    corr_fused module); the key names the wrapper (a key of
    corr_probes.launches; None for K2)."""
    v2 = micro_fused_v2.inputs(dev)
    a5, (sh1, sh2), E5 = v2['args'], v2['sh'], v2['E']
    a7 = micro_onepass_dma.inputs(dev)
    a8 = micro_kernel_variants.inputs(dev)['args']
    a6 = micro_corr_floor.slab_inputs(dev)
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
        ('planes_pair (K4)', 'planes_pair', 'corr_probes',
         lambda m: m.planes_pair(*a5)),
        ('slab (K6)', 'slab', 'corr_probes', lambda m: m.slab(*a6)),
        ('planes_first49 (K7)', 'planes_first49', 'corr_probes',
         lambda m: m.planes_first49(*a7['args'])),
        ('planes_first49 (K7, STREAMS=1)', 'planes_first49_streams',
         'corr_probes',
         lambda m: m.planes_first49(*a7['args'], streams=a7['streams'])),
        ('planes_roll (K5)', 'planes_roll', 'corr_probes',
         lambda m: m.planes_roll(*a5, sh1, sh2)),
        ('planes_roll (K5, zero rolls)', 'planes_roll', 'corr_probes',
         lambda m: m.planes_roll(*a5, zero, zero)),
        ('planes_w12x16 (K8)', 'planes_w12x16', 'corr_probes',
         lambda m: m.planes_w12x16(*a8)),
        ('planes_fixedw (K8)', 'planes_fixedw', 'corr_probes',
         lambda m: m.planes_fixedw(*a8[:4])),
        ('corr_planes (K2, phase 3)', None, 'corr_fused',
         lambda m: m.planes(*k2)),
        ('corr_planes (K2, K4 inputs)', None, 'corr_fused',
         lambda m: m.planes(*k2_v2)),
    ]


def paired_both(new, old, fn):
    """fn on `new` against `old` ((module, library) each) in turns, both
    ways round (new first, then old first): {'new_ms', 'old_ms', 'ratio'
    (new / old, the geometric mean of both orders), 'ratios'}."""
    a, b, r1 = cm.time_paired(on(*new, fn), on(*old, fn))
    c, d, r2 = cm.time_paired(on(*old, fn), on(*new, fn))
    ratio = (a / b * d / c) ** 0.5
    return dict(new_ms=(a + d) / 2, old_ms=(b + c) / 2, ratio=ratio,
                ratios=r1 + [1 / r for r in r2])


def against(dev, csrc, rows, only=None):
    """This checkout's kernels against DIR's in turns (module docstring);
    `only`: the wrapper keys to compare (None: all)."""
    names = ('probe_planes', 'probe_pair_tiles', 'probe_slab',
             'corr_planes_ring')
    mods = {'corr_probes': cp, 'corr_fused': corr_fused}
    with ThreadPoolExecutor(2) as ex:
        sos = dict(zip(mods, ex.map(
            lambda n: compile_lib(csrc, n, 'against'), mods)))
    new, old = {}, {}
    for name, mod in mods.items():
        mod.build()
        new[name] = (mod, mod._lib)
        theirs = module_of(csrc, name)
        old[name] = (theirs, load(sos[name], theirs.SIGNATURES))
    for tag, libs in (('this checkout', (cp.build(), corr_fused.build())),
                      (str(csrc), sos.values())):
        for so in libs:
            for k, v in ptxas(Path(so), names).items():
                print(f'  ptxas ({tag}) {k}: {v}', flush=True)
    for name, key, mod, fn in calls(dev):
        if only and (key or 'corr_planes') not in only:
            continue
        got, ref = on(*new[mod], fn)(), on(*old[mod], fn)()
        err, scale, ok = cm.compare(got, ref)
        if not ok:
            raise RuntimeError(f'{name}: this build vs {csrc} off the bound '
                               f'({err} at {scale})')
        row = paired_both(new[mod], old[mod], fn)
        row.update(name=name, max_abs_diff=err)
        rows.append(row)
        print(f'  {name}: this checkout {row["new_ms"]!r} ms, {csrc} '
              f'{row["old_ms"]!r} ms, ratio {row["ratio"]!r} (rounds '
              f'{min(row["ratios"])!r} .. {max(row["ratios"])!r}); '
              f'max|diff| {err!r}', flush=True)
        new[mod][0]._lib = new[mod][1]
        del got, ref
    torch.cuda.empty_cache()


def sweep(dev, rows, variants=SWEEP, compare=True):
    """The variants (SWEEP, or ABLATIONS with compare False) against this
    checkout's build in turns, on the kernels each changes; with `compare`
    their outputs must equal the checkout's bit for bit."""
    if not variants:
        return
    cp.build()
    base = cp._lib
    srcs = [variant_csrc(v) for v in variants]
    with ThreadPoolExecutor(len(srcs)) as ex:   # one nvcc per variant
        sos = list(ex.map(lambda s: compile_lib(s[0], 'corr_probes', s[1]),
                          srcs))
    todo = calls(dev)
    for variant, so in zip(variants, sos):
        lib = load(so, cp.SIGNATURES)
        for k, v in ptxas(so, ('probe_planes_ring', 'probe_pair_tiles',
                               'probe_slab_tiles')).items():
            print(f'  ptxas {variant}: {k}: {v}', flush=True)
        for name, key, _, fn in todo:
            if key not in changed(variant):
                continue
            if compare:
                ref = on(cp, base, fn)()
                got = on(cp, lib, fn)()
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise RuntimeError(f'{name} {variant}: output differs')
                del got, ref
            ms, base_ms, ratios = cm.time_paired(on(cp, lib, fn),
                                                 on(cp, base, fn))
            rows.append(dict(name=name, variant=variant, ms=ms,
                             base_ms=base_ms, ratio=ms / base_ms,
                             ratios=ratios))
            print(f'  {name} {variant}: {ms!r} ms against the kept '
                  f'{base_ms!r} ms, ratio {ms / base_ms!r} (rounds '
                  f'{min(ratios)!r} .. {max(ratios)!r})', flush=True)
        cp._lib = base
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--against', type=Path)
    ap.add_argument('--sweep', action='store_true')
    ap.add_argument('--ablate', action='store_true')
    ap.add_argument('--only', action='append')
    ap.add_argument('--out', type=Path)
    a = ap.parse_args()
    dev = cm.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f'ring_sweep on {smi}', flush=True)
    rows = {'card': smi, 'against': [], 'sweep': [], 'ablate': []}
    cp.build()
    corr_fused.build()
    def kept(variants):
        return [v for v in variants
                if not a.only or set(changed(v)) & set(a.only)]
    if a.against:
        against(dev, a.against, rows['against'], a.only)
    if a.sweep:
        sweep(dev, rows['sweep'], kept(SWEEP))
    if a.ablate:
        sweep(dev, rows['ablate'], kept(ABLATIONS), compare=False)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(rows, indent=1))


if __name__ == '__main__':
    main()
