"""dpvo_torch.lie against dpvo_tpu.lie on the same seeded numpy inputs.

Both run the same f32 formulas (same Taylor branches); only the order of a
few f32 operations differs, so the tolerance is a few f32 ulps of O(1)
values: atol 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch import lie as tl
from dpvo_tpu import lie as jl

ATOL = 1e-6


def _tangent(n, scale, seed):
    return np.random.RandomState(seed).randn(n, 6).astype(np.float32) * scale


def _close(a_torch, a_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(a_jax), atol=atol,
                               rtol=0)


# small scales exercise the Taylor branches (theta^2 < 1e-8, |qv|^2 < 1e-12)
SCALES = [1e-6, 1e-3, 0.7]


@pytest.mark.parametrize('scale', SCALES)
def test_exp_log(scale):
    xi = _tangent(64, scale, 0)
    _close(tl.se3_exp(torch.from_numpy(xi)), jl.se3_exp(jnp.asarray(xi)))
    X = np.array(jl.se3_exp(jnp.asarray(xi)))
    _close(tl.se3_log(torch.from_numpy(X)), jl.se3_log(jnp.asarray(X)),
           atol=ATOL * 10)     # log divides by |qv|: a few more ulps


@pytest.mark.parametrize('scale', SCALES)
def test_group_ops(scale):
    a = np.array(jl.se3_exp(jnp.asarray(_tangent(32, scale, 1))))
    b = np.array(jl.se3_exp(jnp.asarray(_tangent(32, scale, 2))))
    xi = _tangent(32, scale, 3)
    rng = np.random.RandomState(4)
    p4 = rng.randn(32, 4).astype(np.float32)
    cov = rng.randn(32, 6).astype(np.float32)
    A, B = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    _close(tl.se3_inv(A), jl.se3_inv(ja))
    _close(tl.se3_mul(A, B), jl.se3_mul(ja, jb))
    _close(tl.se3_act4(A, torch.from_numpy(p4)),
           jl.se3_act4(ja, jnp.asarray(p4)), atol=1e-5)
    _close(tl.se3_adjT(A, torch.from_numpy(cov)),
           jl.se3_adjT(ja, jnp.asarray(cov)), atol=1e-5)
    _close(tl.se3_retr(A, torch.from_numpy(xi)),
           jl.se3_retr(ja, jnp.asarray(xi)))


def test_broadcasting_matches():
    """(GP, 1, 7) poses acting on (GP, M, 4) points, as the BA does."""
    a = np.array(jl.se3_exp(jnp.asarray(_tangent(5, 0.3, 5))))[:, None]
    p4 = np.random.RandomState(6).randn(5, 7, 4).astype(np.float32)
    _close(tl.se3_act4(torch.from_numpy(a), torch.from_numpy(p4)),
           jl.se3_act4(jnp.asarray(a), jnp.asarray(p4)), atol=1e-5)
