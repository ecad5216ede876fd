"""Port parity: the k-NN of ``init_from_points`` (``ops/knn.py``).

``mean_sq_dist_knn3`` is held to JAX's at rtol 1e-4 + atol 1e-6 x max|x|^2:
both expand ``|x|^2 + |y|^2 - 2 <x, y>`` in fp32 (TF32 off in the port),
whose cancellation error scales with the squared coordinates; the two
libraries sum the 3-term dot in their own order.  Duplicate points are
neighbours at distance 0 (self is excluded by index).  Morton codes and
the window variant, which computes each difference exactly, are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops import knn as jknn
from gs_deformable_tpu_torch.ops import knn

from test_knn import brute_mean_sq_3nn


def clouds():
    rng = np.random.default_rng(0)
    normal = rng.normal(size=(700, 3))
    dup = rng.normal(size=(50, 3))
    far = rng.uniform(-1, 1, (400, 3)) + np.array([30.0, -20.0, 5.0])
    grid = np.stack(np.meshgrid(*[np.linspace(0, 1, 8)] * 3), -1).reshape(-1, 3)
    return {"normal": normal, "duplicates": np.concatenate([dup, dup[:10], dup[:3]]),
            "offset": far, "grid": grid}


CLOUDS = clouds()


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("block", [64, 256])
def test_mean_sq_dist_knn3(name, block):
    pts = CLOUDS[name].astype(np.float32)
    want = np.asarray(jknn.mean_sq_dist_knn3(jnp.asarray(pts), block=block))
    got = knn.mean_sq_dist_knn3(torch.from_numpy(pts), block=block).numpy()
    assert got.dtype == np.float32
    atol = 1e-6 * float(np.abs(pts).max()) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got, brute_mean_sq_3nn(pts.astype(np.float64)), rtol=1e-4,
                               atol=atol)
    if name == "duplicates":  # rows 0-2 have two copies each: 3-NN (0, 0, d)
        np.testing.assert_array_equal(got[[0, 1, 2]], got[[60, 61, 62]])
        assert (got[:3] < got[3:10].max()).all()


@pytest.mark.parametrize("n, rows", [(1_000, 4096), (100_000, 2684), (5_000_000, 53),
                                     (1 << 30, 1)])
def test_block_rows(n, rows):
    assert knn.block_rows(n) == rows
    assert rows == 1 or rows * n * 4 <= 1 << 30  # a block's fp32 distances within 1 GiB


@pytest.mark.parametrize("n, elements", [(300, 1 << 14), (2_000, 1 << 16)])
def test_mean_sq_dist_knn3_budget_blocks(n, elements):
    """Blocks sized by a distance budget smaller than the cloud: the same
    result as JAX's and as one block's."""
    block = knn.block_rows(n, elements)
    assert block * n <= elements and block < n
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    want = np.asarray(jknn.mean_sq_dist_knn3(jnp.asarray(pts)))
    atol = 1e-6 * float(np.abs(pts).max()) ** 2
    for got in (knn.mean_sq_dist_knn3(torch.from_numpy(pts), block=block),
                knn.mean_sq_dist_knn3(torch.from_numpy(pts))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("name", list(CLOUDS))
def test_morton_codes(name):
    pts = CLOUDS[name].astype(np.float32)
    want = np.asarray(jknn.morton_codes(jnp.asarray(pts))).astype(np.int64)
    np.testing.assert_array_equal(knn.morton_codes(torch.from_numpy(pts)).numpy(), want)


@pytest.mark.parametrize("name", list(CLOUDS))
@pytest.mark.parametrize("window", [4, 32])
def test_window_variant(name, window):
    pts = CLOUDS[name].astype(np.float32)
    want = np.asarray(jknn.mean_sq_dist_knn3_window(jnp.asarray(pts), window=window))
    got = knn.mean_sq_dist_knn3_window(torch.from_numpy(pts), window=window).numpy()
    np.testing.assert_array_equal(got, want)
