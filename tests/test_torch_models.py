"""dpvo_torch models against dpvo_tpu on the same seeded inputs and weights:
encoders + patchify, the update operator (pair-blocked and segment paths),
weights (seeded init, .npz loading, layout round trip), config defaults,
and import hygiene (the port never imports jax).

Tolerances: in f32 both sides run the same ops, summed in another order —
atol 2e-4 on O(1) activations through ~10 conv / linear layers. In bf16
each side rounds at its own places; the bound is a few bf16 ulps of the
tensor's scale (5e-2 * max|ref|)."""
import copy
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.models.checkpoint import (init_vonet_params, load_network,
                                          state_dict_from_jax)
from dpvo_torch.models.vonet import VONet
from dpvo_tpu.models.checkpoint import convert_torch_state_dict
from dpvo_tpu.models.extractor import basic_encoder4
from dpvo_tpu.models.vonet import (VONetParams, init_vonet_params as jax_init,
                                   patchify_frame, update_op)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, 'artifacts', 'micro_vonet.npz')
DIM = 384


@pytest.fixture(scope='module')
def weights():
    z = np.load(NPZ)
    params = {k: z[k] for k in z.files}
    net = VONet(device='cpu')
    net.load_state_dict(state_dict_from_jax(params))
    return params, net.eval().requires_grad_(False)


def _image(H=64, W=96, seed=0):
    rng = np.random.RandomState(seed)
    return (2.0 * rng.randint(0, 256, (H, W, 3)) / 255.0 - 0.5
            ).astype(np.float32)


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize('which, norm', [('fnet', 'instance'),
                                         ('inet', 'none')])
def test_encoder_f32(weights, which, norm):
    params, net = weights
    x = _image(seed=1)
    ref = basic_encoder4(VONetParams.from_f32(params).f32,
                         f'patchify.{which}', jnp.asarray(x[None]), norm)
    out = getattr(net.patchify, which)(
        torch.from_numpy(x).permute(2, 0, 1)[None])
    _close(out.permute(0, 2, 3, 1), ref, atol=2e-4)


@pytest.mark.parametrize('mixed', [False, True])
def test_patchify_frame(weights, mixed):
    params, net = weights
    img = _image(seed=2)
    rng = np.random.RandomState(3)
    coords = np.stack([rng.uniform(1, 23, 12), rng.uniform(1, 15, 12)],
                      -1).astype(np.float32)
    jp = VONetParams.from_f32(params)
    ref = patchify_frame(jp, jnp.asarray(img).astype(
        jnp.bfloat16 if mixed else jnp.float32), jnp.asarray(coords),
        mixed_precision=mixed)
    m = copy.deepcopy(net).to(torch.bfloat16) if mixed else net
    out = m.patchify_frame(torch.from_numpy(img).to(m.dtype),
                           torch.from_numpy(coords))
    for k in ('fmap1', 'fmap2', 'gmap', 'imap', 'patch_xy', 'clr'):
        r = np.asarray(ref[k], np.float32)
        tol = 5e-2 * np.abs(r).max() if mixed else 2e-4
        if k == 'clr':
            tol *= 255
        _close(out[k], r, atol=tol)


def _pair_table(GP=12, M=6, pmem=5, seed=0):
    """A pair-blocked edge table like DeviceVO's: valid pairs first, sorted
    by target, some sources sharing a ring slot group."""
    rng = np.random.RandomState(seed)
    nvalid = GP - 3
    pi = rng.randint(0, 4, GP)
    pj = np.sort(rng.randint(0, 5, GP))
    pv = np.arange(GP) < nvalid
    E = GP * M
    net = rng.randn(E, DIM).astype(np.float32) * 0.5
    inp = rng.randn(E, DIM).astype(np.float32) * 0.5
    corr = rng.randn(E, 882).astype(np.float32)
    psl = (pi + 1) % pmem
    return dict(GP=GP, M=M, pmem=pmem, pi=pi, pj=pj, pv=pv, net=net, inp=inp,
                corr=corr, psl=psl)


@pytest.mark.parametrize('mixed', [False, True])
def test_update_op_pairs(weights, mixed):
    """The pair-blocked path (gather_pairs) DeviceVO runs every update."""
    from dpvo_torch.runtime.device_vo import _pair_neighbors as t_nb
    from dpvo_tpu.runtime.device_vo import _pair_neighbors as j_nb
    params, net = weights
    d = _pair_table()
    GP, M, pmem = d['GP'], d['M'], d['pmem']
    jix, jjx = j_nb(jnp.asarray(d['pi']), jnp.asarray(d['pj']),
                    jnp.asarray(d['pv']), GP)
    tix, tjx = t_nb(torch.from_numpy(d['pi']), torch.from_numpy(d['pj']),
                    torch.from_numpy(d['pv']))
    np.testing.assert_array_equal(tix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(tjx.numpy(), np.asarray(jjx))
    ix_pair = tix.numpy()
    jx_pair = tjx.numpy()
    ar = np.arange(M)
    ix_e = np.where(ix_pair[:, None] >= 0, ix_pair[:, None] * M + ar,
                    -1).reshape(-1)
    jx_e = np.where(jx_pair[:, None] >= 0, jx_pair[:, None] * M + ar,
                    -1).reshape(-1)
    kk_ids = (d['psl'][:, None] * M + ar).reshape(-1)
    pair_ids = np.repeat(np.arange(GP), M)
    mask = np.repeat(d['pv'], M)
    kw = dict(num_segments=GP * M, num_segments_kk=pmem * M,
              num_segments_ij=GP)

    jp = VONetParams.from_f32(params)
    rn, rd, rw = update_op(
        jp, jnp.asarray(d['net']), jnp.asarray(d['inp']),
        jnp.asarray(d['corr']), jnp.asarray(ix_e, jnp.int32),
        jnp.asarray(jx_e, jnp.int32), jnp.asarray(kk_ids, jnp.int32),
        jnp.asarray(pair_ids, jnp.int32), edge_mask=jnp.asarray(mask),
        mixed_precision=mixed, gather_pairs=(jix, jjx, M), **kw)
    m = copy.deepcopy(net).to(torch.bfloat16) if mixed else net
    on, od, ow = m.update_op(
        torch.from_numpy(d['net']), torch.from_numpy(d['inp']),
        torch.from_numpy(d['corr']), torch.from_numpy(ix_e),
        torch.from_numpy(jx_e), torch.from_numpy(kk_ids),
        torch.from_numpy(pair_ids), edge_mask=torch.from_numpy(mask),
        gather_pairs=(tix, tjx, M), **kw)
    for o, r in ((on, rn), (od, rd), (ow, rw)):
        r = np.asarray(r, np.float32)
        _close(o, r, atol=5e-2 * np.abs(r).max() if mixed else 2e-4)


def test_update_op_segment_probe(weights):
    """The segment path, as the motion probe calls it: one pair, no
    temporal neighbors, per-patch groups (device_vo.py:476-480)."""
    params, net = weights
    M = 8
    rng = np.random.RandomState(5)
    inp = rng.randn(M, DIM).astype(np.float32)
    corr = rng.randn(M, 882).astype(np.float32)
    neg = np.full(M, -1)
    ids = np.arange(M)
    zeros = np.zeros(M, np.int64)
    jp = VONetParams.from_f32(params)
    rn, rd, rw = update_op(
        jp, jnp.zeros((M, DIM)), jnp.asarray(inp), jnp.asarray(corr),
        jnp.asarray(neg, jnp.int32), jnp.asarray(neg, jnp.int32),
        jnp.asarray(ids, jnp.int32), jnp.asarray(zeros, jnp.int32),
        num_segments=M, edge_mask=jnp.ones(M, bool), mixed_precision=False)
    on, od, ow = net.update_op(
        torch.zeros(M, DIM), torch.from_numpy(inp), torch.from_numpy(corr),
        torch.from_numpy(neg), torch.from_numpy(neg), torch.from_numpy(ids),
        torch.from_numpy(zeros), num_segments=M,
        edge_mask=torch.ones(M, dtype=torch.bool))
    for o, r in ((on, rn), (od, rd), (ow, rw)):
        _close(o, r, atol=2e-4)


def test_update_op_segment_groups(weights):
    """Segment path with real temporal neighbors, shared groups and masked
    edges."""
    params, net = weights
    E, G = 20, 6
    rng = np.random.RandomState(6)
    netx = rng.randn(E, DIM).astype(np.float32) * 0.5
    inp = rng.randn(E, DIM).astype(np.float32) * 0.5
    corr = rng.randn(E, 882).astype(np.float32)
    ix = np.where(rng.rand(E) < 0.7, rng.randint(0, E, E), -1)
    jx = np.where(rng.rand(E) < 0.7, rng.randint(0, E, E), -1)
    kk = rng.randint(0, G, E)
    pair = rng.randint(0, G, E)
    mask = rng.rand(E) < 0.8
    jp = VONetParams.from_f32(params)
    rn, rd, rw = update_op(
        jp, jnp.asarray(netx), jnp.asarray(inp), jnp.asarray(corr),
        jnp.asarray(ix, jnp.int32), jnp.asarray(jx, jnp.int32),
        jnp.asarray(kk, jnp.int32), jnp.asarray(pair, jnp.int32),
        num_segments=G, edge_mask=jnp.asarray(mask), mixed_precision=False)
    on, od, ow = net.update_op(
        *(torch.from_numpy(a) for a in (netx, inp, corr, ix, jx, kk, pair)),
        num_segments=G, edge_mask=torch.from_numpy(mask))
    for o, r in ((on, rn), (od, rd), (ow, rw)):
        _close(o, r, atol=2e-4)


def test_init_params_identical():
    ours = init_vonet_params(0)
    ref = jax_init(0)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_state_dict_round_trip():
    """JAX dict -> state_dict -> JAX dict is the identity, and the
    state_dict loads into VONet with exactly the reference names."""
    params = jax_init(1)
    sd = state_dict_from_jax(params)
    back = convert_torch_state_dict(sd)
    assert sorted(back) == sorted(params)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    net = VONet(device='cpu')
    assert sorted(net.state_dict()) == sorted(sd)
    net.load_state_dict(sd)


def test_load_network_npz(weights):
    sd = load_network(NPZ)
    assert sd['update.corr.0.weight'].shape == (384, 882)
    assert sd['patchify.fnet.conv1.weight'].shape == (32, 3, 7, 7)
    ref = weights[1].state_dict()
    for k, v in sd.items():
        assert torch.equal(v, ref[k]), k


def test_config_defaults_match():
    from dpvo_torch.config import cfg as tcfg
    from dpvo_tpu.config import cfg as jcfg
    assert dict(tcfg) == dict(jcfg)
    a, b = tcfg.clone(), jcfg.clone()
    for path in ('config/default.yaml', 'config/fast.yaml'):
        a.merge_from_file(os.path.join(REPO, path))
        b.merge_from_file(os.path.join(REPO, path))
        assert dict(a) == dict(b)
    a.merge_from_list(['BUFFER_SIZE', '128', 'MIXED_PRECISION=false'])
    b.merge_from_list(['BUFFER_SIZE', '128', 'MIXED_PRECISION=false'])
    assert dict(a) == dict(b)


def test_port_never_imports_jax():
    """Importing the port (every module) leaves jax out of sys.modules. A
    subprocess: this test process has jax loaded already."""
    code = (
        'import sys, dpvo_torch, dpvo_torch.runtime, dpvo_torch.lie, '
        'dpvo_torch.ba_pairs, dpvo_torch.ops.corr, dpvo_torch.ops.corr_onepass, '
        'dpvo_torch.ops.patchify, dpvo_torch.ops.scatter, '
        'dpvo_torch.models.vonet, dpvo_torch.models.checkpoint\n'
        'bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.") '
        'or m.startswith("dpvo_tpu")]\n'
        'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)
