"""Port parity: the offset net (deform_offsets) vs the JAX package, both tiers.

The JAX net's numpy weights go through convert.from_jax_numpy.  Bars:
- "float32": rtol 1e-5 / atol 1e-6 (fp32 sums in another order);
- "bfloat16": products of bf16-rounded operands are exact in fp32 on both
  sides, but an activation that lands 1 fp32 ulp apart can round to
  neighbouring bf16 values (2^-8 relative) before the next layer, so the
  bar is atol 2e-3 on outputs of magnitude ~0.3, and the mean error must
  stay below 1e-4.

The bf16 trunk function itself is held bitwise (forward) and within fp32
summation (gradients) to the same tiers written layer by layer
(``trunk_cases.layerwise``), for the offset and SE(3) nets.  At full width
(the 8 x 256 nets, 4,096 rows) its outputs and every gradient are held to
the JAX package's "bfloat16" tier (``trunk_jax_reference.compute``), and
so is the stored copy of that reference that the card tests read, in L2
norm: outputs within 2^-10, gradients within 2^-5.  The two sides sum in
another order, so some bf16 roundings of activations and cotangents flip
by one step, and a flipped cotangent spreads along its row through the
later products.  Readings on the CPU, port against JAX: outputs 2.17e-4
(offset) and 2.21e-4 (SE(3)), gradients up to 4.78e-3 and 6.97e-3; the
stored copy reads 0 but for the trunk inputs' gradients, which it keeps
rounded to bf16 (1.73e-3 and 1.77e-3).
"""

import functools

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

import trunk_cases
import trunk_jax_reference

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



@pytest.mark.parametrize("kind", ["offset", "se3"])
@pytest.mark.parametrize("tier", ["bfloat16", "bfloat16_bwd"])
def test_bf16_trunk_matches_the_layerwise_formulation(tier, kind):
    """The bf16 trunk function (``_Bf16Trunk``) on the CPU against the same
    tier written layer by layer: forward bitwise, every gradient (weights,
    biases, xyz) within fp32 summation order.  A skip in the middle and the
    four (two) heads are all on the path; the heads' cotangents are fp32."""
    cfg = DeformConfig(depth=5, width=48, skips=(2,), multires_xyz=4, multires_time=3,
                       sh_coeffs=4)
    if kind == "offset":
        net = tdeform.OffsetNet(tdeform.init_offset_params(7, cfg), cfg, device="cpu")
    else:
        net = tdeform.SE3Net(tdeform.init_se3_params(7, cfg), cfg, device="cpu")
    rng = np.random.default_rng(8)
    xyz = torch.tensor(rng.uniform(-1.5, 1.5, (301, 3)), dtype=torch.float32,
                       requires_grad=True)
    tcol = torch.full((301, 1), 0.625)
    params = list(net.parameters())

    def run(fn):
        out = fn()
        cot = [torch.tensor(rng.normal(size=o.shape), dtype=torch.float32) for o in out]
        loss = sum((o * c).sum() for o, c in zip(out, cot))
        return out, torch.autograd.grad(loss, [xyz, *params])

    if kind == "offset":
        def ins():
            return tdeform.posenc(xyz, cfg.multires_xyz), tdeform.posenc(tcol, cfg.multires_time)
    else:
        def ins():
            return xyz, tcol
    state = rng.bit_generator.state
    got, got_g = run(lambda: net(xyz, tcol, tier))
    rng.bit_generator.state = state  # the same cotangents on both sides
    ref, ref_g = run(lambda: trunk_cases.layerwise(net, *ins(), tier))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and torch.equal(g, r)
    assert len(got_g) == 1 + 2 * (cfg.depth + len(net.heads))
    for g, r in zip(got_g, ref_g):
        assert g.shape == r.shape and bool(r.abs().max() > 0)
        torch.testing.assert_close(g, r, rtol=1e-6, atol=0)


def test_three_way_split_is_exact():
    """``_split3``, which carries the heads' fp32 cotangent into bf16 products
    on the card: hi + mid + lo is the fp32 value exactly from 2^-110 up to
    fp32's largest and at bf16 rounding ties; below, bf16's coarser
    subnormals drop what lies under 2^-133.  The padding columns are zeros."""
    rng = np.random.default_rng(9)
    g = rng.normal(size=(513, 58)) * 10.0 ** rng.uniform(-30, 30, (513, 1))
    g = torch.tensor(g, dtype=torch.float32)
    g[0, :6] = torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -9, -(1 + 2 ** -9 + 2 ** -23), -3e38,
                             0.0, 2 ** -110 * (1 + 2 ** -23)])
    g[1, :3] = torch.tensor([2 ** -149, -1.17e-38, 3 * 2 ** -125])
    parts = tdeform._split3(g, 64)
    assert parts.dtype == torch.bfloat16 and parts.shape == (513, 192)
    p = parts.double()
    whole = (p[:, :58] + p[:, 64:122]) + p[:, 128:186]
    tiny = torch.zeros_like(g, dtype=torch.bool)
    tiny[1, :3] = True
    assert torch.equal(whole[~tiny], g.double()[~tiny])
    assert bool(((whole - g.double())[tiny].abs() <= 2.0 ** -133).all())
    assert not bool(p[:, 58:64].any() or p[:, 122:128].any() or p[:, 186:].any())


@functools.lru_cache(maxsize=None)
def _jax_full_width(kind):
    return trunk_jax_reference.compute(kind)


def _l2_gap(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("side", ["port", "stored"])
@pytest.mark.parametrize("kind", trunk_cases.KINDS)
def test_full_width_bf16_trunk_matches_jax(kind, side):
    """The 8 x 256 trunk at 4,096 rows in the "bfloat16" tier against the JAX
    package's on the CPU, forward and the gradients of every weight, bias
    and trunk input (bars and readings in the module docstring): the port's
    ``_Bf16Trunk`` ("port"), or the stored reference that the card tests
    hold the tensor-core route to ("stored")."""
    ref_out, ref_grads = _jax_full_width(kind)
    if side == "stored":
        out, grads = trunk_cases.load_jax_reference(kind)
    else:
        params, x, t, cot = trunk_cases.full_width_case(kind)
        cls = tdeform.OffsetNet if kind == "offset" else tdeform.SE3Net
        net = cls(params, DeformConfig(), device="cpu")
        x, t = (torch.from_numpy(a).requires_grad_(True) for a in (x, t))
        out = torch.cat(tdeform.DeformMLP.forward(net, x, t, "bfloat16"), dim=1)
        weights = [p for m in (*net.layers, *net.heads) for p in (m.w, m.b)]
        grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), [x, t, *weights])
        out, grads = out.detach().numpy(), [g.numpy() for g in grads]
    assert out.shape == ref_out.shape == (trunk_cases.FULL_ROWS, 58 if kind == "offset" else 6)
    assert _l2_gap(out, ref_out) <= 2.0 ** -10
    assert len(grads) == len(ref_grads) == 2 + 2 * (8 + (4 if kind == "offset" else 2))
    for g, r in zip(grads, ref_grads):
        assert g.shape == r.shape and bool(np.abs(r).max() > 0)
        assert _l2_gap(g, r) <= 2.0 ** -5
