"""Port parity: the offset net (deform_offsets) vs the JAX package, both tiers.

The JAX net's numpy weights go through convert.from_jax_numpy.  Bars:
- "float32": rtol 1e-5 / atol 1e-6 (fp32 sums in another order);
- "bfloat16": products of bf16-rounded operands are exact in fp32 on both
  sides, but an activation that lands 1 fp32 ulp apart can round to
  neighbouring bf16 values (2^-8 relative) before the next layer, so the
  bar is atol 2e-3 on outputs of magnitude ~0.3, and the mean error must
  stay below 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.config import DeformConfig as JDeformConfig
from gs_deformable_tpu.models import deform as jdeform
from gs_deformable_tpu_torch import convert
from gs_deformable_tpu_torch.config import Config, DeformConfig
from gs_deformable_tpu_torch.models import deform as tdeform

SMALL = dict(depth=3, width=64, skips=(1,), warmup_iters=100)


def _nets(seed, **over):
    jcfg = JDeformConfig(**{**SMALL, **over})
    params = jdeform.init_offset_net(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = Config(deform=DeformConfig(**{**SMALL, **over}))
    _, net = convert.from_jax_numpy({"xyz": np.zeros((1, 3), np.float32),
                                     "f_dc": np.zeros((1, 1, 3), np.float32),
                                     "f_rest": np.zeros((1, 15, 3), np.float32),
                                     "opacity": np.zeros((1, 1), np.float32),
                                     "scaling": np.zeros((1, 3), np.float32),
                                     "rotation": np.zeros((1, 4), np.float32),
                                     "alive": np.ones(1, bool)},
                                    np_params, cfg, device="cpu")
    return params, jcfg, net, cfg.deform


@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_deform_offsets_match_jax(tier):
    params, jcfg, net, cfg = _nets(0, compute_dtype=tier)
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-2, 2, (257, 3)).astype(np.float32)
    t = 0.375
    jdtype = jnp.bfloat16 if tier == "bfloat16" else None
    ref = jdeform.deform_offsets(params, jnp.asarray(xyz), t, jnp.asarray(500), jcfg,
                                 compute_dtype=jdtype)
    got = tdeform.deform_offsets(net, torch.from_numpy(xyz), t, 500, cfg)
    assert [g.shape for g in got] == [(257, 3), (257, 3), (257, 4), (257, 48)]
    for g, r in zip(got, ref):
        g, r = g.detach().numpy(), np.asarray(r)
        if tier == "float32":
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-3)
            assert np.abs(g - r).mean() < 1e-4


@pytest.mark.parametrize("iteration", [0, 99])
def test_warmup_gate_zeroes_offsets(iteration):
    params, jcfg, net, cfg = _nets(2, compute_dtype="float32")
    xyz = np.random.default_rng(3).normal(size=(9, 3)).astype(np.float32)
    ref = jdeform.deform_offsets(params, jnp.asarray(xyz), 0.5, jnp.asarray(iteration), jcfg)
    got = tdeform.deform_offsets(net, torch.from_numpy(xyz), 0.5, iteration, cfg)
    for g, r in zip(got, ref):
        assert not np.asarray(r).any() and not g.any()


def test_posenc_and_numpy_roundtrip():
    x = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tdeform.posenc(torch.from_numpy(x), 4).numpy(),
                               np.asarray(jdeform.posenc(jnp.asarray(x), 4)),
                               rtol=1e-6, atol=1e-6)
    params, _, net, _ = _nets(5)
    back = net.numpy_params()
    for group in ("layers", "heads"):
        for a, b in zip(back[group], params[group]):
            np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))
            np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))


def test_numpy_init_matches_torch_default_init_bounds():
    cfg = DeformConfig()
    p = tdeform.init_offset_params(0, cfg)
    assert len(p["layers"]) == 8 and [h["w"].shape[1] for h in p["heads"]] == [3, 3, 4, 48]
    assert p["layers"][0]["w"].shape == (84, 256) and p["layers"][5]["w"].shape == (319, 256)
    w0 = p["layers"][0]["w"]
    assert np.abs(w0).max() <= np.sqrt(3.0 / 84) and w0.dtype == np.float32
