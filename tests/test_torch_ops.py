"""Small ops of the port against dpvo_tpu on the same seeded inputs: patch
extraction and pooling (borders included), segment softmax / sum, the host
centroid selection (RANDOM and GRADIENT_BIAS draw the same numbers from the
same RandomState) and the host SE3 helpers.

Tolerance: f32 elementwise math on both sides, atol 1e-5 on O(1) values;
the host numpy copies must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpvo_torch.ops.patchify import avg_pool2d, extract_patches
from dpvo_torch.ops.scatter import segment_softmax, segment_sum
from dpvo_torch.runtime import centroid as t_centroid
from dpvo_torch.runtime import numpy_se3 as t_se3
from dpvo_tpu.ops import patchify as j_patchify
from dpvo_tpu.ops import scatter as j_scatter
from dpvo_tpu.runtime import centroid as j_centroid
from dpvo_tpu.runtime import numpy_se3 as j_se3


@pytest.mark.parametrize('radius', [0, 1])
def test_extract_patches_borders(radius):
    rng = np.random.RandomState(radius)
    fmap = rng.randn(12, 16, 8).astype(np.float32)
    coords = np.concatenate([rng.uniform(-2, 18, (20, 2)),
                             rng.uniform(1, 11, (10, 2))]).astype(np.float32)
    ref = j_patchify.extract_patches(jnp.asarray(fmap), jnp.asarray(coords),
                                     radius)
    out = extract_patches(torch.from_numpy(fmap), torch.from_numpy(coords),
                          radius)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_avg_pool2d():
    x = np.random.RandomState(2).randn(8, 12, 5).astype(np.float32)
    np.testing.assert_allclose(
        avg_pool2d(torch.from_numpy(x), 4).numpy(),
        np.asarray(j_patchify.avg_pool2d(jnp.asarray(x), 4)), atol=1e-6,
        rtol=0)


def test_segment_softmax_and_sum():
    rng = np.random.RandomState(3)
    x = rng.randn(30, 4).astype(np.float32)
    ids = rng.randint(0, 7, 30)                 # segment 6 may be empty
    mask = rng.rand(30) < 0.7
    ref = j_scatter.segment_softmax(jnp.asarray(x), jnp.asarray(ids), 8,
                                    mask=jnp.asarray(mask))
    out = segment_softmax(torch.from_numpy(x), torch.from_numpy(ids), 8,
                          mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(
        segment_sum(torch.from_numpy(x), torch.from_numpy(ids), 8).numpy(),
        np.asarray(j_scatter.segment_sum(jnp.asarray(x), jnp.asarray(ids),
                                         8)), atol=1e-6, rtol=0)


@pytest.mark.parametrize('strategy', ['RANDOM', 'GRADIENT_BIAS'])
def test_select_coords_same_draws(strategy):
    from dpvo_torch.config import cfg
    c = cfg.clone()
    c.CENTROID_SEL_STRAT = strategy
    img = np.random.RandomState(4).randint(0, 256, (64, 96, 3), np.uint8)
    a = t_centroid.select_coords(c, np.random.RandomState(9), img, 16, 16, 24)
    b = j_centroid.select_coords(c, np.random.RandomState(9), img, 16, 16, 24)
    np.testing.assert_array_equal(a, b)


def test_numpy_se3_same():
    rng = np.random.RandomState(5)
    xi = (rng.randn(6, 6) * 0.3).astype(np.float32)
    g = j_se3.exp(xi)
    np.testing.assert_array_equal(t_se3.inv(g), j_se3.inv(g))
    np.testing.assert_array_equal(t_se3.mul(g, g[::-1]), j_se3.mul(g, g[::-1]))
    pts = rng.randn(6, 3).astype(np.float32)
    np.testing.assert_array_equal(t_se3.quat_rotate(g[:, 3:], pts),
                                  j_se3.quat_rotate(g[:, 3:], pts))
