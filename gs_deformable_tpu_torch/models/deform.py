"""The time-conditioned offset network (port of ``gs_deformable_tpu/models/deform.py``).

``OffsetNet`` is the active 4-head ``DirectTemporalNeRF``: posenc(xyz) (63)
and posenc(t) (21) -> 8 ReLU layers of width 256, with the encoded xyz
re-concatenated in front after layer 4 -> heads dx (3), d_scale (3),
d_rot (4), d_shs (48), run as one concatenated matmul.

Weights keep the JAX orientation: ``w`` is (in, out) and a layer is
``x @ w + b``.  Compute tiers:

- "float32": fp32 matmuls (TF32 off, see ``device.pin_fp32``);
- "bfloat16" (default): operands rounded to bf16 and multiplied in fp32, as
  the JAX dot with ``preferred_element_type=float32`` does.  A bf16
  ``torch.matmul`` would round its output to bf16 too, which the JAX tier
  does not.  Autograd rounds each cotangent at the cast back to bf16,
  exactly as the transpose of JAX's ``astype(bfloat16)`` does;
- "bfloat16_bwd" (``DeformConfig.bf16_cotangents``): the same forward, and
  a backward that rounds the incoming cotangent to bf16 before both
  transposed products (fp32 sums), as JAX's ``_bf16_mm`` (deform.py:71-104);
- "float32_3x" runs as "float32".

The warmup gate is a Python ``if`` on ``iteration``: during warmup the net
is not run and gets no gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .. import device as device_rules
from ..config import DeformConfig


def posenc_dim(multires: int, input_dims: int) -> int:
    return input_dims * (1 + 2 * multires)


def posenc(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]."""
    feats = [x]
    for i in range(multires):
        freq = 2.0 ** i
        feats.append(torch.sin(x * freq))
        feats.append(torch.cos(x * freq))
    return torch.cat(feats, dim=-1)


def init_offset_params(seed: int, cfg: DeformConfig = DeformConfig()) -> Dict[str, list]:
    """Numpy weights in the JAX pytree layout ``{"layers": [...], "heads": [...]}``.

    torch's nn.Linear default init (kaiming-uniform a=sqrt(5) weights,
    uniform +-1/sqrt(fan_in) biases), drawn from ``numpy.random.default_rng(seed)``.
    """
    rng = np.random.default_rng(seed)
    in_dim = posenc_dim(cfg.multires_xyz, 3) + posenc_dim(cfg.multires_time, 1)
    skip_dim = posenc_dim(cfg.multires_xyz, 3)

    def linear(fan_in, fan_out):
        bw = math.sqrt(6.0 / fan_in) / math.sqrt(2.0)
        bb = 1.0 / math.sqrt(fan_in)
        return {"w": rng.uniform(-bw, bw, (fan_in, fan_out)).astype(np.float32),
                "b": rng.uniform(-bb, bb, (fan_out,)).astype(np.float32)}

    layers, fan_in = [], in_dim
    for i in range(cfg.depth):
        layers.append(linear(fan_in, cfg.width))
        fan_in = cfg.width + (skip_dim if i in cfg.skips else 0)
    heads = [linear(cfg.width, d) for d in (3, 3, 4, cfg.sh_coeffs * 3)]
    return {"layers": layers, "heads": heads}


class _Dense(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor, tier: str) -> torch.Tensor:
        return _matmul(x, self.w, tier) + self.b


class _Bf16CotangentMatmul(torch.autograd.Function):
    """bf16-rounded operands, fp32 product; the backward rounds the cotangent
    to bf16 before ``g @ w.T`` and ``x.T @ g`` (JAX's ``_bf16_mm``)."""

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


def _matmul(x: torch.Tensor, w: torch.Tensor, tier: str) -> torch.Tensor:
    if tier == "bfloat16_bwd":
        return _Bf16CotangentMatmul.apply(x, w)
    if tier == "bfloat16":
        x = x.to(torch.bfloat16).to(torch.float32)
        w = w.to(torch.bfloat16).to(torch.float32)
    return x @ w


class OffsetNet(nn.Module):
    """DirectTemporalNeRF offset net; ``forward(xyz, t)`` -> (dx, d_scale, d_rot, d_shs)."""

    def __init__(self, params: Dict[str, list], cfg: DeformConfig = DeformConfig(),
                 device="cuda"):
        super().__init__()
        self.cfg = cfg
        device = device_rules.resolve(device)

        def dense(p):
            return _Dense(torch.tensor(np.asarray(p["w"], np.float32), device=device),
                          torch.tensor(np.asarray(p["b"], np.float32), device=device))

        self.layers = nn.ModuleList(dense(p) for p in params["layers"])
        self.heads = nn.ModuleList(dense(p) for p in params["heads"])

    @property
    def head_dims(self) -> List[int]:
        return [h.w.shape[1] for h in self.heads]

    def forward(self, xyz: torch.Tensor, t: torch.Tensor,
                tier: str = "float32") -> Tuple[torch.Tensor, ...]:
        """``tier``: "float32", "bfloat16" or "bfloat16_bwd" (see module)."""
        if tier not in ("float32", "bfloat16", "bfloat16_bwd"):
            raise ValueError(f"unknown tier {tier!r}")
        xe = posenc(xyz, self.cfg.multires_xyz)
        te = posenc(t, self.cfg.multires_time)
        h = torch.cat([xe, te], dim=-1)
        for i, layer in enumerate(self.layers):
            h = torch.relu(layer(h, tier))
            if i in self.cfg.skips:
                h = torch.cat([xe, h], dim=-1)
        wcat = torch.cat([hd.w for hd in self.heads], dim=1)
        bcat = torch.cat([hd.b for hd in self.heads], dim=0)
        out = _matmul(h, wcat, tier) + bcat
        return tuple(torch.split(out, self.head_dims, dim=1))

    def param_tree(self) -> Dict[str, list]:
        """The parameters themselves in the JAX pytree layout
        ``{"layers": [{"w", "b"}...], "heads": [...]}``."""
        return {"layers": [{"w": m.w, "b": m.b} for m in self.layers],
                "heads": [{"w": m.w, "b": m.b} for m in self.heads]}

    def numpy_params(self) -> Dict[str, list]:
        """Weights back in the JAX pytree layout (numpy)."""
        def tree(mods):
            return [{"w": m.w.detach().cpu().numpy(), "b": m.b.detach().cpu().numpy()}
                    for m in mods]

        return {"layers": tree(self.layers), "heads": tree(self.heads)}


def deform_offsets(net: OffsetNet, xyz: torch.Tensor, time, iteration: int,
                   cfg: DeformConfig = DeformConfig()):
    """(dx, d_scale, d_rot, d_shs); all zeros, MLP skipped, while iteration < warmup."""
    n = xyz.shape[0]
    if int(iteration) < cfg.warmup_iters:
        z = xyz.new_zeros
        return z((n, 3)), z((n, 3)), z((n, 4)), z((n, cfg.sh_coeffs * 3))
    t = torch.as_tensor(time, dtype=torch.float32, device=xyz.device).reshape(-1, 1)
    t = t.expand(n, 1)
    tier = "float32"
    if cfg.compute_dtype == "bfloat16":
        tier = "bfloat16_bwd" if cfg.bf16_cotangents else "bfloat16"
    return net(xyz, t, tier)
