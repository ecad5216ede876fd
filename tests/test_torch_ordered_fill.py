"""Port parity: gs_deformable_tpu_torch ordered fill vs the JAX ordered_fill kernels.

The plain versions (what the port runs on the CPU) must equal the JAX
functions bit for bit on the cases of tests/test_ordered_fill.py and on the
adversarial position sets of tests/fill_cases.py.  The
CUDA kernel is held to its plain version by tests/test_torch_kernels_cuda.py
and by chip_smoke.py at the render-path shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops.pallas.ordered_fill import ordered_place_i32, ordered_prefix_fill
from gs_deformable_tpu_torch.ops.kernels import launch_counts, ordered_fill as tof

import fill_cases

PREFIX_CASES = [(0, 500, 4096, 0.5), (1, 2000, 2000, 1.0), (2, 64, 8192, 0.0),
                (3, 3000, 1000, 0.3), (4, 1, 1, 1.0)]
PLACE_CASES = [(0, 500, 4096, 0.5), (1, 2000, 2000, 1.0), (2, 64, 8192, 0.0),
               (5, 2048, 600_000, 1.0)]


def _case(seed, n, K, frac_valid):
    rng = np.random.default_rng(seed)
    nval = int(n * frac_valid)
    pos = np.sort(rng.choice(max(K, 1), min(nval, K), replace=False)).astype(np.int32)
    tail = K + 7 + np.arange(n - pos.shape[0], dtype=np.int32)  # ascending OOB
    return np.concatenate([pos, tail])


def _prefix_inputs(seed, n, K, frac, C=3):
    pos = _case(seed, n, K, frac)
    delta = np.random.default_rng(seed + 100).integers(-1000, 1000, (n, C)).astype(np.int32)
    return pos, delta


def _place_inputs(seed, n, K, frac):
    pos = _case(seed, n, K, frac)
    vals = np.random.default_rng(seed + 200).integers(0, 1 << 20, n).astype(np.int32)
    return pos, vals


@pytest.mark.parametrize("seed,n,K,frac", PREFIX_CASES)
def test_prefix_fill_matches_jax_bitwise(seed, n, K, frac):
    pos, delta = _prefix_inputs(seed, n, K, frac)
    ref = np.asarray(ordered_prefix_fill(jnp.asarray(pos), jnp.asarray(delta, jnp.float32), K))
    before = launch_counts()
    got = tof.ordered_prefix_fill(torch.from_numpy(pos), torch.from_numpy(delta), K)
    assert got.dtype == torch.int32 and got.shape == (3, K)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))
    assert launch_counts() == before  # CPU tensors never launch a kernel


@pytest.mark.parametrize("seed,n,K,frac", PLACE_CASES)
def test_place_matches_jax_bitwise(seed, n, K, frac):
    pos, vals = _place_inputs(seed, n, K, frac)
    ref = np.asarray(ordered_place_i32(jnp.asarray(pos), jnp.asarray(vals), K))
    got = tof.ordered_place_i32(torch.from_numpy(pos), torch.from_numpy(vals), K)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_prefix_fill_channel_counts(C):
    pos, delta = _prefix_inputs(7, 700, 3000, 0.6, C=C)
    got = tof.ordered_prefix_fill(torch.from_numpy(pos), torch.from_numpy(delta), 3000)
    seg = np.zeros((3000, C), np.int64)
    ok = pos < 3000
    seg[pos[ok]] = delta[ok]
    np.testing.assert_array_equal(got.numpy(), np.cumsum(seg, 0).T.astype(np.int32))


def test_wrappers_reject_bad_inputs():
    pos = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tof.ordered_prefix_fill(pos, torch.zeros((4, 9), dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        tof.ordered_prefix_fill(pos.long(), torch.zeros((4, 2), dtype=torch.int32), 10)
    with pytest.raises(ValueError):
        tof.ordered_place_i32(pos, torch.zeros(4, dtype=torch.float32), 10)


@pytest.mark.parametrize("kind,K,C", fill_cases.PREFIX_CASES)
def test_prefix_fill_adversarial_matches_jax(kind, K, C):
    """The position sets the card kernel is tested on (block edges, a segment
    over many blocks, K not a multiple of 4, nothing in range, n = 0, every
    channel count), held bitwise against JAX through the plain version."""
    pos = fill_cases.positions(kind, K)
    delta = fill_cases.values(pos.shape[0], C, 1000)
    ref = np.asarray(ordered_prefix_fill(jnp.asarray(pos), jnp.asarray(delta, jnp.float32), K))
    got = tof.ordered_prefix_fill(torch.from_numpy(pos), torch.from_numpy(delta), K)
    assert got.dtype == torch.int32 and got.shape == (C, K)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("kind,K", fill_cases.PLACE_CASES)
def test_place_adversarial_matches_jax(kind, K):
    pos = fill_cases.positions(kind, K)
    vals = np.abs(fill_cases.values(pos.shape[0], 1, 1 << 20)[:, 0])
    ref = np.asarray(ordered_place_i32(jnp.asarray(pos), jnp.asarray(vals), K))
    got = tof.ordered_place_i32(torch.from_numpy(pos), torch.from_numpy(vals), K)
    np.testing.assert_array_equal(got.numpy(), ref)
