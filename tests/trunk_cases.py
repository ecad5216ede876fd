"""References for the deformation trunk in the bf16 tiers
(``models.deform._Bf16Trunk``), importing no JAX, so that the card tests
(``test_torch_kernels_cuda.py``) can use them where JAX is not installed.

- ``layerwise``: the tiers written layer by layer, as the port ran them
  before its trunk became one autograd function;
- ``full_width_case`` and ``load_jax_reference``: the 8 x 256 offset and
  SE(3) trunks at 4,096 rows, and what the JAX package's "bfloat16" tier
  gives there on the CPU, forward and gradients, as stored in
  ``golden/trunk_jax_bf16.npz`` by ``trunk_jax_reference.py``.
"""

import os

import numpy as np
import torch

from gs_deformable_tpu_torch.config import DeformConfig
from gs_deformable_tpu_torch.models import deform as tdeform

FULL_ROWS, FULL_SEED = 4096, 3
KINDS = ("offset", "se3")
JAX_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                             "trunk_jax_bf16.npz")


class Bf16CotangentMatmul(torch.autograd.Function):
    """The "bfloat16_bwd" tier's product as the port wrote it layer by layer:
    bf16-rounded operands, fp32 product; the backward rounds the cotangent to
    bf16 before ``g @ w.T`` and ``x.T @ g``."""

    @staticmethod
    def forward(ctx, x, w):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        return xb.to(torch.float32) @ wb.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        xb, wb = (t.to(torch.float32) for t in ctx.saved_tensors)
        gb = g.to(torch.bfloat16).to(torch.float32)
        return gb @ wb.t(), xb.t() @ gb


def layerwise(net, x, t, tier):
    """The bf16 tiers as a layer-by-layer autograd graph: every operand cast
    to bf16 and back to fp32 before an fp32 product ("bfloat16", autograd
    rounding each cotangent at the cast), or ``Bf16CotangentMatmul``."""
    def mm(a, w):
        if tier == "bfloat16_bwd":
            return Bf16CotangentMatmul.apply(a, w)
        return a.to(torch.bfloat16).to(torch.float32) @ w.to(torch.bfloat16).to(torch.float32)

    h = torch.cat([x, t], dim=-1)
    for i, layer in enumerate(net.layers):
        h = torch.relu(mm(h, layer.w) + layer.b)
        if i in net.cfg.skips:
            h = torch.cat([x, h], dim=-1)
    out = (mm(h, torch.cat([hd.w for hd in net.heads], dim=1))
           + torch.cat([hd.b for hd in net.heads]))
    return tuple(torch.split(out, net.head_dims, dim=1))


def _posenc64(x: np.ndarray, multires: int) -> np.ndarray:
    """``models.deform.posenc`` in float64, rounded once to fp32: the same
    bits on any machine's libm."""
    feats = [x]
    for i in range(multires):
        feats += [np.sin(x * 2.0 ** i), np.cos(x * 2.0 ** i)]
    return np.concatenate(feats, axis=-1).astype(np.float32)


def full_width_case(kind: str):
    """The default 8 x 256 ``kind`` ("offset" or "se3") net at FULL_ROWS rows:
    (numpy weights in the JAX layout, the trunk's two inputs, the heads'
    cotangent side by side), all fp32 numpy from FULL_SEED.  The offset
    net's inputs are its encoded xyz and time (``_posenc64``), the SE(3)
    net's the raw ones; xyz in the D-NeRF init's cube, one frame time."""
    cfg = DeformConfig()
    rng = np.random.default_rng(FULL_SEED)
    xyz = rng.uniform(-1.3, 1.3, (FULL_ROWS, 3))
    t = np.full((FULL_ROWS, 1), 0.4)
    if kind == "offset":
        params = tdeform.init_offset_params(FULL_SEED, cfg)
        x, t = _posenc64(xyz, cfg.multires_xyz), _posenc64(t, cfg.multires_time)
    else:
        params = tdeform.init_se3_params(FULL_SEED, cfg)
        x, t = xyz.astype(np.float32), t.astype(np.float32)
    heads = sum(h["w"].shape[1] for h in params["heads"])
    cot = rng.normal(size=(FULL_ROWS, heads)).astype(np.float32)
    return params, x, t, cot


def param_list(params) -> list:
    """The weights in ``_Bf16Trunk``'s order: each layer's ``w, b``, then each head's."""
    return [p[k] for p in (*params["layers"], *params["heads"]) for k in ("w", "b")]


def load_jax_reference(kind: str):
    """(heads' outputs side by side, gradients of ``[x, t, *param_list]``),
    fp32 numpy, as ``trunk_jax_reference.py`` stored them; the gradients of
    the inputs were stored rounded to bf16 (2^-9 relative at most)."""
    with np.load(JAX_REFERENCE) as f:
        def get(key):
            if f"{key}.bf16" in f.files:
                bits = f[f"{key}.bf16"].astype(np.uint32) << 16
                return bits.view(np.float32)
            return f[key]
        grads = [get(f"{kind}.g{i}") for i in range(int(f[f"{kind}.grads"]))]
        return get(f"{kind}.out"), grads
