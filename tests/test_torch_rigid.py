"""Port parity: the SE(3)/SO(3) maps of ``ops/rigid.py`` against the JAX package.

The same seeded numpy inputs go through both; bar rtol 1e-6 / atol 1e-6.
The JAX 3x3 products run at ``Precision.HIGHEST`` (full fp32 on the CPU);
the port writes them out elementwise, fp32 whatever the matmul settings.
Angles run from 1e-4 (where ``1 - cos`` and ``θ - sin θ`` cancel) to π.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops import rigid as jrigid
from gs_deformable_tpu_torch.ops import rigid

N = 64


def inputs(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    theta = np.concatenate([10.0 ** rng.uniform(-4, 0, N // 2), rng.uniform(0, np.pi, N // 2)])
    v = rng.normal(size=(N, 3))
    return (w.astype(np.float32), theta.astype(np.float32), v.astype(np.float32),
            rng.normal(size=(N, 3, 3)).astype(np.float32),
            rng.normal(size=(N, 4)).astype(np.float32))


CASES = {
    "skew": lambda m, w, th, v, R, h: m.skew(w),
    "exp_so3": lambda m, w, th, v, R, h: m.exp_so3(w, th),
    "rp_to_se3": lambda m, w, th, v, R, h: m.rp_to_se3(R, v),
    "exp_se3": lambda m, w, th, v, R, h: m.exp_se3(_cat(m, w, v), th),
    "to_homogenous": lambda m, w, th, v, R, h: m.to_homogenous(v),
    "from_homogenous": lambda m, w, th, v, R, h: m.from_homogenous(h),
}


def _cat(m, w, v):
    return torch.cat([w, v], -1) if m is rigid else jnp.concatenate([w, v], -1)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_rigid_maps_match_jax(name, seed):
    arrays = inputs(seed)
    ref = np.asarray(CASES[name](jrigid, *(jnp.asarray(a) for a in arrays)))
    got = CASES[name](rigid, *(torch.from_numpy(a) for a in arrays)).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_exp_se3_is_rigid():
    """The transform keeps distances and has a unit bottom row."""
    w, th, v, _, _ = inputs(2)
    T = rigid.exp_se3(torch.from_numpy(np.concatenate([w, v], -1)), torch.from_numpy(th))
    R = T[:, :3, :3].double()
    eye = torch.eye(3, dtype=torch.float64).expand(N, 3, 3)
    assert torch.allclose(R @ R.transpose(1, 2), eye, atol=1e-5)
    assert torch.equal(T[:, 3], torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(N, 4))


def test_products_ignore_tf32_setting():
    """The 3x3 products are elementwise: the matmul precision setting cannot
    change them."""
    w, th, v, _, _ = inputs(3)
    S, t = torch.from_numpy(np.concatenate([w, v], -1)), torch.from_numpy(th)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        a = rigid.exp_se3(S, t)
        torch.set_float32_matmul_precision("medium")
        b = rigid.exp_se3(S, t)
    finally:
        torch.set_float32_matmul_precision(old)
    assert torch.equal(a, b)
