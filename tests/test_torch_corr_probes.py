"""dpvo_torch's correlation probes (ops/corr_probes.py, K4-K8) against the
Pallas probes of scripts/micro_fused_v2.py, micro_corr_floor.py,
micro_onepass_dma.py and micro_kernel_variants.py, on the same numpy
inputs, on the CPU: the port runs the plain versions of its kernels, the
probes run in Pallas interpret mode.

The scripts cannot be imported (their timing loops run at module level,
at full size), so `_probe` takes the kernel and wrapper defs out of a
script with `ast` and execs them with small module constants (E = 64,
maps 32x48 or 64x80, 3 frames), `pl.pallas_call` bound to interpret=True.
Nothing under scripts/ or dpvo_tpu/ changes. The probes' padded slabs,
phase-shifted maps and bit-packed scalars are built from the port's
unpadded maps and image-coordinate bases, as
tests/test_torch_corr_fused.py does for K2.

Tolerances, each with its reason:
  * bf16 planes (K4, K5, K6 dots2 / slab, K8): both sides sum the same
    128 f32 products of bf16 values in another order, then round to bf16:
    |port - probe| <= 2^-7 |probe| + 1e-5 max|probe| (the second term for
    entries that cancel to near zero).
  * f32 outputs (K6 dots, K7): the sum order only, <= 1e-5 max|probe|.
  * K4 against dpvo_tpu's K2 (_planes_fused): K2's planes from a dot of
    another shape, so as for bf16 planes above.
  * K7 STREAMS=0 against STREAMS=1: the same arithmetic, bitwise equal.
"""
import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dpvo_torch.ops import corr_fused as tcf
from dpvo_torch.ops import corr_probes as cp
from dpvo_torch.scripts import (micro_corr_floor, micro_fused_v2,
                                micro_kernel_variants, micro_onepass_dma)
from dpvo_tpu.ops import corr_fused as jcf

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / 'scripts'
C, P2, E = 128, 9, 64
# the Pallas module with every call in interpret mode
PL_INTERPRET = types.SimpleNamespace(
    **{k: getattr(pl, k) for k in dir(pl) if not k.startswith('__')})
PL_INTERPRET.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def _probe(script, names, consts, edit=None):
    """The top-level defs `names` of scripts/<script>, exec'd in a
    namespace of jax, jnp, pl (interpret mode), pltpu, partial and
    `consts`. edit(tree_of_def) may rewrite a def's AST first. Returns the
    namespace."""
    tree = ast.parse((SCRIPTS / script).read_text())
    defs = {n.name: n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names}
    assert set(defs) == set(names), sorted(defs)
    if edit is not None:
        for node in defs.values():
            edit(node)
            ast.fix_missing_locations(node)
    ns = dict(jax=jax, jnp=jnp, pl=PL_INTERPRET, pltpu=pltpu,
              partial=functools.partial, **consts)
    exec(compile(ast.Module(body=[defs[n] for n in names], type_ignores=[]),
                 str(SCRIPTS / script), 'exec'), ns)
    return ns


def _bf16_np(rng, *shape):
    """N(0, 1) rounded to bf16, as f32 numpy."""
    a = rng.randn(*shape).astype(np.float32)
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t if dtype is None else t.to(dtype)


def _assert_bf16_close(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    bound = 2 ** -7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    assert np.abs(ref).max() > 0
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


def _assert_f32_close(got, ref):
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# K4, K5: scripts/micro_fused_v2.py
# ---------------------------------------------------------------------------

H, W, F = 32, 48, 3


@functools.lru_cache(maxsize=None)
def _fused_v2():
    return _probe('micro_fused_v2.py', ['_plane_kernel_k2', 'planes_k2',
                                        '_plane_kernel_roll', 'planes_roll'],
                  dict(EB=jcf.EB, WY=jcf.WY, WX=jcf.WX, WY2=jcf.WY2,
                       WX2=jcf.WX2, C=C, P2=P2, E=E))


def _fused_case(seed=0):
    """The script's inputs at E = 64, 32x48 maps: g9, maps, sorted jslot,
    coords over the image with a +-1 px jitter per pixel; the JAX side's
    pa / pb (micro_fused_v2.py:64-70) and window ints, the port's
    image-coordinate bases."""
    rng = np.random.RandomState(seed)
    g9 = _bf16_np(rng, E, P2, C)
    f1 = _bf16_np(rng, F, H, W, C)
    f2 = _bf16_np(rng, F, H // 4, W // 4, C)
    jj = np.sort(rng.randint(0, F, E)).astype(np.int32)
    cx = rng.uniform(4, W - 5, (E, 1, 1)) + rng.uniform(-1, 1, (E, 3, 3))
    cy = rng.uniform(4, H - 5, (E, 1, 1)) + rng.uniform(-1, 1, (E, 3, 3))
    coords = np.stack([cx, cy], -1).astype(np.float32)
    co = jnp.asarray(coords)
    xi1, _, _, _, by1, bx1, _, _ = jcf._window_base(co, H, W, 3)
    xi2, _, _, _, by2, bx2, _, _ = jcf._window_base(co / 4.0, H // 4, W // 4,
                                                    3, align=4, wy=jcf.WY2)
    ph2 = (bx2 // 4) % 2
    bx2s = bx2 - 4 * ph2
    jax_side = dict(
        g9=jnp.asarray(g9, jnp.bfloat16),
        fp1=jcf.pad_slab(jnp.asarray(f1, jnp.bfloat16)),
        fp2=jcf.pad_slab2(jnp.asarray(f2, jnp.bfloat16)),
        pa=jnp.asarray(jj) | (by1 << 8) | ((bx1 // 8) << 18),
        pb=by2 | ((bx2s // 8) << 10) | (ph2 << 18),
        xi1=xi1, xi2=xi2, bx1=bx1, bx2s=bx2s, ph2=ph2)
    cot = _t(coords)
    w1 = tcf.window_base(cot, H, W, 8)
    w2 = tcf.window_base(cot / 4.0, H // 4, W // 4, 4)
    port = dict(args=(_t(g9, torch.bfloat16), _t(f1, torch.bfloat16),
                      _t(f2, torch.bfloat16), _t(jj), w1[4], w1[5], w2[4],
                      w2[5]), xi1=w1[0], xi2=w2[0])
    return jax_side, port


def _k4_probe(js):
    return _fused_v2()['planes_k2'](js['g9'], js['fp1'], js['fp2'], js['pa'],
                                    js['pb'])


def _split_pairs(jj):
    """Second edges of the probe's pairs (2 e2, 2 e2 + 1) whose target frame
    differs from their partner's."""
    e = np.arange(len(jj))
    return (e % 2 == 1) & (jj != np.roll(jj, 1))


def test_planes_pair_matches_probe_k4():
    """On every edge but those of test_k4_probe_reads_a_pairs_first_frame,
    whose frame the probe does not load."""
    js, port = _fused_case()
    q = _k4_probe(js)
    ok = ~_split_pairs(port['args'][3].numpy())
    # the probe computes K2's planes (its off-diagonal products are
    # discarded), its (18, 896) dot summing in another order
    p = jcf._planes_fused(js['g9'], js['fp1'], js['fp2'], js['pa'], js['pb'],
                          interpret=True)
    for a, b in zip(q, p):
        _assert_bf16_close(np.asarray(a, np.float32)[ok], b[ok])
    before = dict(cp.launches)
    got = cp.planes_pair(*port['args'])
    assert cp.launches == before          # CPU tensors: the plain version
    assert got[0].shape == (E, P2, 288) and got[1].shape == (E, P2, 160)
    for g, r in zip(got, q):
        assert g.dtype == torch.bfloat16
        _assert_bf16_close(g[torch.from_numpy(ok)], r[ok])


def test_k4_probe_reads_a_pairs_first_frame():
    """micro_fused_v2.py:102-111 loads the target frame of the first edge
    of each pair only, so the second edge of a pair that straddles a frame
    boundary is dotted with its window in its partner's frame. The port
    computes each edge against its own frame (what the probe meant)."""
    js, port = _fused_case()
    q = _k4_probe(js)
    jj = port['args'][3].numpy()
    split = _split_pairs(jj)
    assert split.any()
    wrong = port['args'][:3] + (torch.from_numpy(np.where(
        split, np.roll(jj, 1), jj)),) + port['args'][4:]
    got, meant = cp.planes_pair(*wrong), cp.planes_pair(*port['args'])
    for g, m, r in zip(got, meant, q):
        _assert_bf16_close(g[torch.from_numpy(split)], r[split])
        assert (m[torch.from_numpy(split)] != g[torch.from_numpy(split)]
                ).any()


def _script_shifts(js):
    """sh1 / sh2 as micro_fused_v2.py:240-246 computes them (slab
    coordinates)."""
    sh1 = (jnp.min(js['xi1'], axis=1) - 3 - (js['bx1'] - jcf.TX))
    sh2 = (jnp.min(js['xi2'], axis=1) - 3 - (js['bx2s'] - jcf.TX))
    return sh1.astype(jnp.int32), sh2.astype(jnp.int32)


def test_planes_roll_matches_probe_k5():
    js, port = _fused_case(seed=1)
    sh1, sh2 = _script_shifts(js)
    args = port['args']
    psh1, psh2 = micro_fused_v2.roll_shifts(port['xi1'], args[5],
                                            port['xi2'], args[7])
    np.testing.assert_array_equal(psh1.numpy(), np.asarray(sh1))
    np.testing.assert_array_equal(psh2.numpy(), np.asarray(sh2))
    assert 0 <= int(sh1.min()) and int(sh1.max()) <= 7
    r1, r2 = _fused_v2()['planes_roll'](js['g9'], js['fp1'], js['fp2'],
                                        js['pa'] | (sh1 << 26),
                                        js['pb'] | (sh2 << 19))
    got = cp.planes_roll(*args, psh1, psh2)
    for g, r in zip(got, (r1, r2)):
        _assert_bf16_close(g, r)
    # rolled column c is K2's column c + sh (micro_fused_v2.py:252-258)
    plain = cp.planes_pair_plain(*args)
    e = int(np.argmax(np.asarray(sh1)))
    s = int(sh1[e])
    assert s > 0
    assert torch.equal(got[0][e, :, :288 - s], plain[0][e, :, s:])


def test_level2_roll_overshoots_phase1_edges():
    """micro_fused_v2.py:244 measures level 2's slack from the phase slab's
    base bx2s = bx2 - 4 * ph2, where the plane starts at bx2: for phase-1
    edges sh2 is the true slack + 4, so it spans 0-7 where the slack is
    0-3. The port keeps the script's shift."""
    js, port = _fused_case(seed=2)
    _, sh2 = _script_shifts(js)
    ph2 = np.asarray(js['ph2'])
    # the true slack: from the window's own base (image coordinates)
    slack = (port['xi2'].amin(1) - 3 - port['args'][7]).numpy()
    assert ((slack >= 0) & (slack <= 3)).all()
    assert (ph2 == 1).any() and (ph2 == 0).any()
    sh2 = np.asarray(sh2)
    np.testing.assert_array_equal(sh2[ph2 == 0], slack[ph2 == 0])
    np.testing.assert_array_equal(sh2[ph2 == 1], slack[ph2 == 1] + 4)
    assert sh2.max() > 3


# ---------------------------------------------------------------------------
# K6: scripts/micro_corr_floor.py
# ---------------------------------------------------------------------------

H4, W4, WIN, BLK = 32, 48, 384, 16


def _floor_consts():
    return dict(E=E, P2=P2, C=C, W=WIN, W2=256, BLK=BLK, H4=H4, W4=W4,
                WY=16, WX=16)


def _index_row(node):
    """fused_kernel's `by_ref[m]` / `bx_ref[m]` -> `[0, m]`: its SMEM
    blocks are (1, BLK), so the unmodified probe slices a row where
    dynamic_slice needs a scalar."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name) \
                and sub.value.id in ('by_ref', 'bx_ref'):
            sub.slice = ast.Tuple(elts=[ast.Constant(0), sub.slice],
                                  ctx=ast.Load())


def _floor_case(seed=3):
    rng = np.random.RandomState(seed)
    g9 = _bf16_np(rng, E, P2, C)
    win = _bf16_np(rng, E, WIN, C)
    fmap = _bf16_np(rng, H4, W4, C)
    by = rng.randint(0, H4 - 16, E).astype(np.int32)
    bx = (rng.randint(0, (W4 - 16) // 8, E) * 8).astype(np.int32)
    return g9, win, fmap, by, bx


def test_dots_match_probe_k6():
    g9, win, _, _, _ = _floor_case()
    ns = _probe('micro_corr_floor.py', ['dot_kernel', 'pallas_dots',
                                        'dot_kernel2', 'pallas_dots2'],
                _floor_consts())
    gj, wj = jnp.asarray(g9, jnp.bfloat16), jnp.asarray(win, jnp.bfloat16)
    gt, wt = _t(g9, torch.bfloat16), _t(win, torch.bfloat16)
    _assert_f32_close(cp.dots(gt, wt), ns['pallas_dots'](gj, wj))
    # the script feeds dot_kernel2 win[:, :256]; the port reads those rows
    # of the full windows
    got = cp.dots2(gt, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (E, P2, 256)
    _assert_bf16_close(got, ns['pallas_dots2'](gj, wj[:, :256]))


def dots_schedule(E, grid, chunks, stages):
    """probe_dots' order of work (csrc/corr_probes.cu): for each block b of
    the persistent grid, the (edge, chunk, stage, parity) its producer
    fills and its consumers drain, in that order. Block b takes edges b,
    b + grid, ...; its k-th chunk (rows [chunk * rows, + rows) of an edge)
    goes to stage k % stages and fills it for the (k // stages)-th time:
    the consumers wait for the full barrier's phase of parity
    (k // stages) & 1, the producer for the empty barrier's phase of the
    other parity (the stage's previous drain). A block's i-th edge takes
    g buffer i % 2 with parity (i // 2) & 1 in the same way."""
    out = []
    for b in range(min(grid, E)):
        work, k = [], 0
        for e in range(b, E, grid):
            for c in range(chunks):
                work.append((e, c, k % stages, (k // stages) & 1))
                k += 1
        out.append(work)
    return out


def _run_ring(work, stages, rng):
    """One block's ring, driven only by the parity waits of dots_schedule
    (a wait for parity p passes once the barrier's phase of parity p has
    completed, i.e. while its count of completed phases is odd for p = 0
    and even for p = 1), producer and consumer steps in a random
    interleaving. Returns the (edge, chunk) the consumer read, in order;
    fails on an overwrite of an unread stage or a read of a stale one."""
    full, empty = [0] * stages, [0] * stages
    slot = [None] * stages

    def passes(completed, parity):
        return completed % 2 != parity

    p = q = 0
    read = []
    while q < len(work):
        steps = []
        if p < len(work) and passes(empty[work[p][2]], work[p][3] ^ 1):
            steps.append('fill')
        if q < p and passes(full[work[q][2]], work[q][3]):
            steps.append('drain')
        assert steps, f'deadlock at fill {p}, drain {q}'
        if rng.choice(steps) == 'fill':
            e, c, s, _ = work[p]
            assert slot[s] is None, f'stage {s} overwritten before read'
            slot[s] = (e, c)
            full[s] += 1
            p += 1
        else:
            e, c, s, _ = work[q]
            assert slot[s] == (e, c), f'stage {s} holds {slot[s]}'
            read.append(slot[s])
            slot[s] = None
            empty[s] += 1
            q += 1
    return read


# (E, grid, chunks, stages): the kernel's own rings (dots: 384 / 128 rows
# in 2 stages, 132 blocks; dots2: 256 / 64 rows in 4 stages, 396 blocks)
# around their grids, then other shapes
@pytest.mark.parametrize('E,grid,chunks,stages', [
    (1, 132, 3, 2), (131, 132, 3, 2), (133, 132, 3, 2), (1029, 132, 3, 2),
    (395, 396, 4, 4), (397, 396, 4, 4), (4099, 396, 4, 4),
    (1, 264, 6, 4), (131, 132, 6, 4), (133, 132, 4, 4), (1029, 264, 6, 3),
    (700, 264, 4, 8), (40, 7, 12, 1), (33, 4, 3, 2)])
def test_dots_schedule_reads_each_row_once(E, grid, chunks, stages):
    """K6's persistent schedule (dots_schedule, as csrc/corr_probes.cu runs
    it): every chunk of every edge is filled and read exactly once, by one
    block, in order; no stage is overwritten before it is read, whatever
    the interleaving of producer and consumers. The g double buffer is the
    same schedule with one chunk per edge and two stages."""
    rng = np.random.RandomState(E)
    sched = dots_schedule(E, grid, chunks, stages)
    assert len(sched) == min(E, grid)
    seen = [(e, c) for work in sched for e, c, _, _ in work]
    assert sorted(seen) == [(e, c) for e in range(E) for c in range(chunks)]
    for b, work in enumerate(sched):
        assert [e for e, *_ in work[::chunks]] == list(range(b, E, grid))
        for _ in range(3):
            assert _run_ring(work, stages, rng) == [(e, c) for e, c, *_ in
                                                    work]
    for work in dots_schedule(E, grid, 1, 2):
        _run_ring(work, 2, rng)


def test_slab_matches_probe_k6_with_scalar_index():
    g9, _, fmap, by, bx = _floor_case(seed=4)
    ns = _probe('micro_corr_floor.py', ['fused_kernel', 'pallas_fused'],
                _floor_consts(), edit=_index_row)
    ref = ns['pallas_fused'](jnp.asarray(g9, jnp.bfloat16),
                             jnp.asarray(fmap, jnp.bfloat16),
                             jnp.asarray(by.reshape(E // BLK, BLK)),
                             jnp.asarray(bx.reshape(E // BLK, BLK)))
    got = cp.slab(_t(g9, torch.bfloat16), _t(fmap, torch.bfloat16), _t(by),
                  _t(bx))
    _assert_bf16_close(got, ref)


def test_unmodified_slab_probe_fails_to_trace():
    """micro_corr_floor.py:128-129 as written: the probe never ran."""
    g9, _, fmap, by, bx = _floor_case(seed=4)
    ns = _probe('micro_corr_floor.py', ['fused_kernel', 'pallas_fused'],
                _floor_consts())
    with pytest.raises(Exception, match='scalar'):
        ns['pallas_fused'](jnp.asarray(g9, jnp.bfloat16),
                           jnp.asarray(fmap, jnp.bfloat16),
                           jnp.asarray(by.reshape(E // BLK, BLK)),
                           jnp.asarray(bx.reshape(E // BLK, BLK)))


# ---------------------------------------------------------------------------
# K7: scripts/micro_onepass_dma.py
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _onepass_dma(streams):
    EB = 32
    return _probe('micro_onepass_dma.py', ['kernel', 'call'],
                  dict(EB=EB, E=E, STREAMS=streams, P2=P2, C=C, R=EB * P2,
                       WY=jcf.WY, WX=jcf.WX, WY2=jcf.WY2, WX2=jcf.WX2))


def test_planes_first49_matches_probe_k7():
    """The script's bases (slab coordinates: by1 < Hp - 12, bx1 8-aligned,
    by2, bx2s and the phase ph2) on 32x48 maps; the port's image bases
    are by - TY, bx - TX (+ 4 * ph2 at level 2)."""
    rng = np.random.RandomState(5)
    g9 = _bf16_np(rng, E, P2, C)
    f1 = _bf16_np(rng, F, H, W, C)
    f2 = _bf16_np(rng, F, H // 4, W // 4, C)
    jj = np.sort(rng.randint(0, F, E)).astype(np.int32)
    by1 = rng.randint(0, 47, E).astype(np.int32)
    bx1 = (rng.randint(0, 10, E) * 8).astype(np.int32)
    by2 = rng.randint(0, 23, E).astype(np.int32)
    bx2s = (rng.randint(0, 6, E) * 8).astype(np.int32)
    ph2 = rng.randint(0, 2, E).astype(np.int32)
    R = E * P2
    pa = jnp.asarray(jj | (by1 << 8) | ((bx1 // 8) << 18))
    pb = jnp.asarray(by2 | ((bx2s // 8) << 10) | (ph2 << 18))
    jargs = (jnp.asarray(g9, jnp.bfloat16),
             jcf.pad_slab(jnp.asarray(f1, jnp.bfloat16)),
             jcf.pad_slab2(jnp.asarray(f2, jnp.bfloat16)), pa, pb,
             jnp.asarray(rng.randint(-9, 9, (R, 1)), jnp.int32),
             jnp.asarray(rng.randn(R, 2), jnp.float32),
             jnp.asarray(rng.randint(-9, 9, (R, 1)), jnp.int32),
             jnp.asarray(rng.randn(R, 2), jnp.float32),
             jnp.asarray(E, jnp.int32))
    ref0 = _onepass_dma(0)['call'](*jargs)
    ref1 = _onepass_dma(1)['call'](*jargs)
    for a, b in zip(ref0, ref1):
        assert jnp.array_equal(a, b)
    port = (_t(g9, torch.bfloat16), _t(f1, torch.bfloat16),
            _t(f2, torch.bfloat16), _t(jj), _t(by1 - jcf.TY),
            _t(bx1 - jcf.TX), _t(by2 - jcf.TY), _t(bx2s - jcf.TX + 4 * ph2))
    got = cp.planes_first49(*port)
    for g, r in zip(got, ref0):
        assert g.shape == (R, 49)
        _assert_f32_close(g, r)


# ---------------------------------------------------------------------------
# K8: scripts/micro_kernel_variants.py
# ---------------------------------------------------------------------------

HV, WV, FV = 64, 80, 3        # level 2 (16x20) must hold a 12x16 window


def _return_outputs(node):
    """run(mode) times its jitted call and returns nothing: keep its body
    up to `fn = jax.jit(...)` and return fn()."""
    if node.name != 'run':
        return
    k = next(i for i, s in enumerate(node.body)
             if isinstance(s, ast.Assign) and s.targets[0].id == 'fn')
    ret = ast.parse('return fn()').body[0]
    node.body = node.body[:k + 1] + [ret]


@pytest.mark.parametrize('mode', ['full', 'twodots', 'rank3', 'fixedw'])
def test_planes_w12x16_match_probe_k8(mode):
    rng = np.random.RandomState(6)
    g9 = _bf16_np(rng, E, P2, C)
    f1 = _bf16_np(rng, FV, HV, WV, C)
    f2 = _bf16_np(rng, FV, HV // 4, WV // 4, C)
    jsl = np.sort(rng.randint(0, FV, E)).astype(np.int32)
    by1 = rng.randint(0, HV - 12, E).astype(np.int32)
    bx1s = (rng.randint(0, (WV - 16) // 8, E) * 8).astype(np.int32)
    ph1 = rng.randint(0, 2, E).astype(np.int32)
    by2 = rng.randint(0, HV // 4 - 12, E).astype(np.int32)
    ph2 = rng.randint(0, 2, E).astype(np.int32)
    ns = _probe('micro_kernel_variants.py', ['make_kernel', 'run'], dict(
        WY=12, WX=16, EB=32, E=E, P2=P2, C=C, H1=HV, W1=WV,
        g9=jnp.asarray(g9, jnp.bfloat16), f1=jnp.asarray(f1, jnp.bfloat16),
        f2=jnp.asarray(f2, jnp.bfloat16),
        pa=jnp.asarray(jsl | (by1 << 8) | ((bx1s // 8) << 18) | (ph1 << 26)),
        pb=jnp.asarray(by2 | (ph2 << 18))), edit=_return_outputs)
    ref = ns['run'](mode)
    maps = (_t(g9, torch.bfloat16), _t(f1, torch.bfloat16),
            _t(f2, torch.bfloat16), _t(jsl))
    if mode == 'fixedw':
        got = cp.planes_fixedw(*maps)
    else:          # a phase is bx + 4 * ph; level 2's x base is 0
        got = cp.planes_w12x16(*maps, _t(by1), _t(bx1s + 4 * ph1), _t(by2),
                               _t(4 * ph2))
    for g, r in zip(got, ref):
        assert g.shape == (E, P2, 192)
        _assert_bf16_close(g, r)


# ---------------------------------------------------------------------------
# the port's probe entry points, at a tiny size on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('script', [micro_fused_v2, micro_corr_floor,
                                    micro_onepass_dma,
                                    micro_kernel_variants],
                         ids=lambda m: m.__name__.rsplit('.', 1)[-1])
def test_probe_entry_point_runs_on_cpu(script):
    before = dict(cp.launches)
    res = script.main(device='cpu', scale=0.0015, seed=0)
    assert cp.launches == before          # plain versions only
    assert res['variants']
    for row in res['variants'].values():
        assert row['kernel'] in cp.launches
        assert row['max_abs_err'] == 0.0 and row['max_abs_plain'] > 0
        assert row['ms'] is None          # no device time off the card
        assert row['bound_ms'] > 0 and row['bound_by'] == 'bytes'
