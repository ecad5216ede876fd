"""Time-conditioned deformation networks (port of ``gs_deformable_tpu/models/deform.py``).

``DeformMLP`` is the shared trunk of every net: ``forward(x, t)`` runs
cat(x, t) through ``depth`` ReLU layers of width ``width``, with ``x``
re-concatenated in front after each layer in ``skips``, then all heads as
one concatenated matmul.  The nets built on it:

- ``OffsetNet``, the active 4-head ``DirectTemporalNeRF``: posenc(xyz) (63)
  and posenc(t) (21) in, posenc(xyz) as the skip input; heads dx (3),
  d_scale (3), d_rot (4), d_shs (48);
- ``SE3Net``: raw xyz and t (3 + 1) in, xyz as the skip input; heads
  w (3), v (3), integrated by ``deform_se3`` into a rigid transform;
- the four latent heads of ``init_latent_params``: rot, scaling,
  opacity_mask and shs.  They take no gradient and no Adam step (the JAX
  step closes over them); only ``opacity_mask`` is used, as the
  multiplicative gate of ``opacity_mask_gate``.

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

The offset and SE(3) nets run in the config's tier.  The opacity gate runs
in fp32 whatever the config says, as JAX's does (deform.py:388 passes no
compute dtype).  The warmup gates are a Python ``if`` on ``iteration``:
during warmup the nets are not run and get no gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import device as device_rules
from .. import tracing
from ..config import DeformConfig
from ..ops import rigid

LATENT_HEADS = ("rot", "scaling", "opacity_mask", "shs")


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


def init_mlp_params(rng: np.random.Generator, in_dim: int, skip_dim: int,
                    head_dims: Sequence[int], depth: int, width: int,
                    skips: Sequence[int]) -> Dict[str, list]:
    """Numpy weights of one trunk and its heads in the JAX pytree layout
    ``{"layers": [...], "heads": [...]}``, drawn from ``rng`` layer by layer.

    torch's nn.Linear default init: kaiming-uniform a=sqrt(5) weights,
    uniform +-1/sqrt(fan_in) biases.  Layer i > 0 takes ``width`` inputs,
    plus ``skip_dim`` after a layer in ``skips``.
    """
    def linear(fan_in, fan_out):
        bw = math.sqrt(6.0 / fan_in) / math.sqrt(2.0)
        bb = 1.0 / math.sqrt(fan_in)
        return {"w": rng.uniform(-bw, bw, (fan_in, fan_out)).astype(np.float32),
                "b": rng.uniform(-bb, bb, (fan_out,)).astype(np.float32)}

    layers, fan_in = [], in_dim
    for i in range(depth):
        layers.append(linear(fan_in, width))
        fan_in = width + (skip_dim if i in skips else 0)
    return {"layers": layers, "heads": [linear(width, d) for d in head_dims]}


def init_offset_params(seed: int, cfg: DeformConfig = DeformConfig()) -> Dict[str, list]:
    """The offset net's numpy weights, from ``numpy.random.default_rng(seed)``."""
    skip_dim = posenc_dim(cfg.multires_xyz, 3)
    return init_mlp_params(np.random.default_rng(seed),
                           skip_dim + posenc_dim(cfg.multires_time, 1), skip_dim,
                           (3, 3, 4, cfg.sh_coeffs * 3), cfg.depth, cfg.width, cfg.skips)


def init_se3_params(seed: int, cfg: DeformConfig = DeformConfig()) -> Dict[str, list]:
    """The SE(3) net's numpy weights (deform.py:305-310): raw xyz and t in,
    no positional encoding, heads w (3) and v (3)."""
    return init_mlp_params(np.random.default_rng(seed), 3 + 1, 3, (3, 3), cfg.depth,
                           cfg.width, cfg.skips)


def init_latent_params(seed: int, cfg: DeformConfig = DeformConfig()) -> Dict[str, dict]:
    """The four latent heads' numpy weights (deform.py:358-370), drawn in
    the order rot, scaling, opacity_mask, shs from one generator."""
    rng = np.random.default_rng(seed)
    te = posenc_dim(cfg.multires_time, 1)
    shapes = {
        "rot": (7 + te, 7, (4,), 3),  # xyz + quaternion, posenc(t)
        "scaling": (6 + 1, 6, (3,), cfg.depth),  # xyz + scale, t
        "opacity_mask": (3 + 1, 3, (1,), cfg.depth),
        "shs": (3 + 1, 3, (cfg.sh_coeffs * 3,), cfg.depth),
    }
    return {k: init_mlp_params(rng, in_dim, skip, heads, depth, cfg.width, cfg.skips)
            for k, (in_dim, skip, heads, depth) in shapes.items()}


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


def config_tier(cfg: DeformConfig) -> str:
    """The matmul tier ``cfg.compute_dtype`` selects (see the module)."""
    if cfg.compute_dtype == "bfloat16":
        return "bfloat16_bwd" if cfg.bf16_cotangents else "bfloat16"
    return "float32"


class DeformMLP(nn.Module):
    """One trunk and its heads; ``forward(x, t, tier)`` -> one tensor per head.

    ``x`` is the skip input: it goes in first and is re-concatenated in
    front after each layer in ``cfg.skips``.  ``params`` is the JAX pytree
    ``{"layers": [{"w", "b"}...], "heads": [...]}`` with numpy leaves.
    """

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

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                tier: str = "float32") -> Tuple[torch.Tensor, ...]:
        """``tier``: "float32", "bfloat16" or "bfloat16_bwd" (see module)."""
        if tier not in ("float32", "bfloat16", "bfloat16_bwd"):
            raise ValueError(f"unknown tier {tier!r}")
        h = torch.cat([x, t], dim=-1)
        for i, layer in enumerate(self.layers):
            h = torch.relu(layer(h, tier))
            if i in self.cfg.skips:
                h = torch.cat([x, h], dim=-1)
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


class OffsetNet(DeformMLP):
    """DirectTemporalNeRF offset net; ``forward(xyz, t)`` -> (dx, d_scale, d_rot, d_shs)."""

    def forward(self, xyz: torch.Tensor, t: torch.Tensor,
                tier: str = "float32") -> Tuple[torch.Tensor, ...]:
        return super().forward(posenc(xyz, self.cfg.multires_xyz),
                               posenc(t, self.cfg.multires_time), tier)


class SE3Net(DeformMLP):
    """DirectTemporalNeRF_se3; ``forward(xyz, t)`` -> (w, v) on raw inputs."""


def make_latent_heads(params: Dict[str, dict], cfg: DeformConfig = DeformConfig(),
                      device="cuda") -> Dict[str, DeformMLP]:
    """The four latent heads as ``DeformMLP``s whose parameters take no
    gradient (``requires_grad`` off), from ``init_latent_params`` or JAX's
    ``make_latent_heads`` as numpy."""
    heads = {}
    for k in LATENT_HEADS:
        heads[k] = DeformMLP(params[k], cfg, device=device).requires_grad_(False)
    return heads


def _time_column(time, xyz: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(time, dtype=torch.float32, device=xyz.device).reshape(-1, 1)
    return t.expand(xyz.shape[0], 1)


def deform_offsets(net: OffsetNet, xyz: torch.Tensor, time, iteration: int,
                   cfg: DeformConfig = DeformConfig()):
    """(dx, d_scale, d_rot, d_shs); all zeros, MLP skipped, while iteration < warmup."""
    with tracing.span("gs.deform"):
        n = xyz.shape[0]
        if int(iteration) < cfg.warmup_iters:
            z = xyz.new_zeros
            return z((n, 3)), z((n, 3)), z((n, 4)), z((n, cfg.sh_coeffs * 3))
        return net(xyz, _time_column(time, xyz), config_tier(cfg))


def deform_se3(net: SE3Net, xyz: torch.Tensor, time, iteration: int,
               cfg: DeformConfig = DeformConfig()) -> torch.Tensor:
    """Positions moved by per-gaussian SE(3) transforms (deform.py:313-355):
    theta = |w|, the screw [w, v] / max(theta, 1e-12) integrated by
    ``exp_se3``, then ``from_homogenous(T @ to_homogenous(xyz))``.  While
    iteration < warmup, ``xyz`` itself and the net is not run."""
    with tracing.span("gs.deform"):
        if int(iteration) < cfg.warmup_iters:
            return xyz
        w, v = net(xyz, _time_column(time, xyz), config_tier(cfg))
        theta = torch.linalg.vector_norm(w, dim=-1)
        safe = torch.clamp(theta, min=1e-12)[..., None]
        transform = rigid.exp_se3(torch.cat([w / safe, v / safe], dim=-1), theta)
        moved = (transform * rigid.to_homogenous(xyz)[:, None, :]).sum(dim=-1)
        return rigid.from_homogenous(moved)


def opacity_mask_gate(latent: Dict[str, DeformMLP], xyz: torch.Tensor, time, iteration: int,
                      cfg: DeformConfig = DeformConfig()) -> torch.Tensor:
    """(N, 1) multiplicative opacity gate in [0, 1] (deform.py:373-398): the
    sigmoid of the ``opacity_mask`` head on raw xyz and t, in fp32 whatever
    ``cfg.compute_dtype`` is; ones while iteration < warmup."""
    with tracing.span("gs.deform"):
        if int(iteration) < cfg.warmup_iters:
            return xyz.new_ones((xyz.shape[0], 1))
        (logit,) = latent["opacity_mask"](xyz, _time_column(time, xyz), "float32")
        return torch.sigmoid(logit)


def rebuild(net: Optional[DeformMLP], params: Dict[str, list], device) -> Optional[DeformMLP]:
    """A net of ``net``'s class and config holding ``params`` (numpy) on ``device``."""
    if net is None:
        return None
    out = type(net)(params, net.cfg, device=device)
    return out.requires_grad_(net.layers[0].w.requires_grad)
