"""The port's plain two-level correlation (dpvo_torch/ops/corr.py, the CPU
path and the CUDA kernel's oracle) against dpvo_tpu: the Pallas one-pass
kernel in interpret mode (as tests/test_corr_onepass.py runs it), including
nv gating and borders, and ops/corr.py for the M = 48 row layout.

Tolerance: both sides take bf16 maps to f32 and sum the same f32 products
in another order (the interpret kernel through f32 planes), so the bound is
1e-4 of the output scale; exact zeros past nv and outside the image."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ops import corr_onepass
from dpvo_torch.ops.corr import corr, corr_two_level
from dpvo_tpu.ops.corr import corr as corr_xla
from dpvo_tpu.ops.corr_onepass import corr_onepass as corr_onepass_jax

from test_corr_fused import make_case

P = 3


def _bf16_case(case):
    """Round the maps to bf16 once; both sides then read identical values."""
    gmap, f1, f2, coords, kk, jj = case
    j = [jnp.asarray(a, jnp.bfloat16) for a in (gmap, f1, f2)]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
         for a in j]
    return j, t, coords, kk, jj


def _ours(t, coords, kk, jj, nv=None):
    return corr_two_level(*t, torch.from_numpy(coords), torch.from_numpy(kk),
                          torch.from_numpy(jj), nv=nv).numpy()


def _check(ours, c1, c2, n):
    c1, c2 = np.asarray(c1), np.asarray(c2)
    scale = max(np.abs(c1).max(), 1e-3)
    np.testing.assert_allclose(ours[:n, ..., 0], c1[:n], atol=1e-4 * scale,
                               rtol=0)
    np.testing.assert_allclose(ours[:n, ..., 1], c2[:n], atol=1e-4 * scale,
                               rtol=0)


def test_matches_onepass_interpret():
    j, t, coords, kk, jj = _bf16_case(make_case())
    c1, c2 = corr_onepass_jax(*j, jnp.asarray(coords), jnp.asarray(kk),
                              jnp.asarray(jj), interpret=True)
    _check(_ours(t, coords, kk, jj), c1, c2, len(kk))


def test_valid_prefix_gating():
    """Edges >= nv are exact zeros in both; edges < nv match."""
    j, t, coords, kk, jj = _bf16_case(make_case(E=96))
    nv = 41                                  # straddles a TPU block
    c1, c2 = corr_onepass_jax(*j, jnp.asarray(coords), jnp.asarray(kk),
                              jnp.asarray(jj), interpret=True,
                              nv=jnp.asarray(nv, jnp.int32))
    ours = _ours(t, coords, kk, jj, nv=torch.tensor(nv))
    _check(ours, c1, c2, nv)
    assert np.all(ours[nv:] == 0.0)
    assert np.all(np.asarray(c1)[nv:] == 0.0)


def test_extreme_borders():
    """Far-outside and negative coords: every out-of-image tap is zero."""
    rng = np.random.RandomState(3)
    F, E, H1, W1 = 2, 32, 64, 96
    gmap = rng.randn(F * 16, P, P, 128).astype(np.float32)
    f1 = rng.randn(F, H1, W1, 128).astype(np.float32)
    f2 = rng.randn(F, H1 // 4, W1 // 4, 128).astype(np.float32)
    cx = np.concatenate([rng.uniform(-9, 2, E // 2),
                         rng.uniform(W1 - 2, W1 + 9, E - E // 2)])
    cy = rng.uniform(-3, H1 + 3, E)
    off = np.linspace(-1.0, 1.0, P)
    gx = np.broadcast_to(cx[:, None, None] + off[None, None, :], (E, P, P))
    gy = np.broadcast_to(cy[:, None, None] + off[None, :, None], (E, P, P))
    coords = np.stack([gx, gy], -1).astype(np.float32)
    kk = rng.randint(0, F * 16, E).astype(np.int32)
    jj = np.sort(rng.randint(0, F, E)).astype(np.int32)
    j, t, coords, kk, jj = _bf16_case((gmap, f1, f2, coords, kk, jj))
    c1, c2 = corr_onepass_jax(*j, jnp.asarray(coords), jnp.asarray(kk),
                              jnp.asarray(jj), interpret=True)
    ours = _ours(t, coords, kk, jj)
    _check(ours, c1, c2, E)
    assert np.array_equal(ours[..., 0] == 0, np.asarray(c1) == 0)


def test_m48_rows_match_xla():
    """fast.yaml's M = 48: pair-blocked kk rows (psl*M + arange(M)). Held
    against ops/corr.py only (the TPU kernel's contiguous-row shortcut is
    wrong when M % 32 != 0)."""
    M, G, F = 48, 6, 3
    _, f1, f2, coords, _, jj = make_case(E=M * G, F=F, seed=4)
    gmap = np.random.RandomState(5).randn(F * M, P, P, 128).astype(np.float32)
    kk = (np.repeat(np.arange(G) % F, M) * M + np.tile(np.arange(M), G)
          ).astype(np.int32)
    j, t, coords, kk, jj = _bf16_case((gmap, f1, f2, coords, kk, jj))
    ours = _ours(t, coords, kk, jj)
    for lvl, (fm, co) in enumerate(((j[1], coords), (j[2], coords / 4.0))):
        ref = np.asarray(corr_xla(j[0], fm, jnp.asarray(co), jnp.asarray(kk),
                                  jnp.asarray(jj)))
        np.testing.assert_allclose(ours[..., lvl], ref,
                                   atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_single_level_matches_xla_f32(monkeypatch):
    """f32 maps, several edge chunks."""
    # the module: the package's name `corr` is the function, as in dpvo_tpu
    corr_mod = importlib.import_module('dpvo_torch.ops.corr')
    monkeypatch.setattr(corr_mod, '_CHUNK', 16)
    gmap, f1, _, coords, kk, jj = make_case(E=40, seed=7)
    ref = np.asarray(corr_xla(jnp.asarray(gmap), jnp.asarray(f1),
                              jnp.asarray(coords), jnp.asarray(kk),
                              jnp.asarray(jj)))
    ours = corr(torch.from_numpy(gmap), torch.from_numpy(f1),
                torch.from_numpy(coords), torch.from_numpy(kk),
                torch.from_numpy(jj)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max(),
                               rtol=0)


def test_wrapper_takes_plain_version_on_cpu():
    """CPU tensors go to the plain version and launch nothing; any other
    non-CUDA device is refused."""
    gmap, f1, f2, coords, kk, jj = make_case(E=16, seed=8)
    args = [torch.from_numpy(a) for a in (gmap, f1, f2, coords, kk, jj)]
    before = corr_onepass.launches
    out = corr_onepass.corr_two_level(*args, nv=10)
    assert corr_onepass.launches == before
    ref = corr_two_level(*args, nv=10)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError):
        corr_onepass.corr_two_level(*[a.to('meta') for a in args])
