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
- "bfloat16" (default): operands rounded to bf16, products summed in fp32
  with an fp32 result, as the JAX dot with ``preferred_element_type=float32``
  does.  Each cotangent is rounded to bf16 where the forward rounded its
  primal, exactly as the transpose of JAX's ``astype(bfloat16)`` does;
- "bfloat16_bwd" (``DeformConfig.bf16_cotangents``): the same forward, and
  a backward that rounds the incoming cotangent to bf16 before both
  transposed products (fp32 sums), as JAX's ``_bf16_mm`` (deform.py:71-104);
- "float32_3x" runs as "float32".

The two bf16 tiers run the whole trunk and its heads as one autograd
function, ``_Bf16Trunk``.  On the card every product takes bf16 operands on
the tensor cores with an fp32 result (``torch.mm(..., out_dtype=float32)``:
a product of two bf16 values is exact in fp32), and each hidden activation
is stored as the bf16 the next layer rounds it to
(``ops.kernels.trunk``).  On the CPU the same function multiplies the
upcast operands, which is the plain mirror of the formulation above.

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
from ..ops.kernels import trunk as trunk_kernels

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


_BF16 = torch.bfloat16
_F32 = torch.float32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fp32 product of two bf16 matrices: on the tensor cores with an
    fp32 result on the card, of the upcast operands on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=_F32)
    return a.to(_F32).mm(b.to(_F32))


def _split3(g: torch.Tensor, cols: int) -> torch.Tensor:
    """fp32 ``g`` (n, k) as bf16 ``[hi | mid | lo]`` (n, 3 * cols), each part
    ``cols`` wide with zeros beyond ``k``: hi = bf16(g), mid = bf16(g - hi),
    lo = bf16(g - hi - mid).  Each difference is exact in fp32 and lo holds
    the last 8 or fewer significant bits, so hi + mid + lo == g wherever
    |g| >= 2^-110 (below, bf16's coarser subnormals drop what lies under
    2^-133)."""
    n, k = g.shape
    out = g.new_zeros((n, 3 * cols), dtype=_BF16)
    rest = g
    for i in range(3):
        part = out[:, i * cols:i * cols + k]
        part.copy_(rest)
        if i < 2:
            rest = rest - part.to(_F32)
    return out


def _exact_heads(a: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The heads' backward products with the fp32 cotangent ``g``, every
    term exact: ``(a.T @ g, g @ w.T)`` for bf16 ``a`` and ``w``.  On the card
    ``g`` goes in once split into three bf16 parts, summed in fp32; on the
    CPU as it is."""
    if not a.is_cuda:
        return a.to(_F32).t().mm(g), g.mm(w.to(_F32).t())
    k = g.shape[1]
    cols = -(-k // 8) * 8
    g3 = _split3(g, cols)
    p = torch.mm(a.t(), g3, out_dtype=_F32)
    w3 = w.new_zeros((3 * cols, w.shape[0]))
    for i in range(3):
        w3[i * cols:i * cols + k] = w.t()
    return ((p[:, :k] + p[:, cols:cols + k]) + p[:, 2 * cols:2 * cols + k],
            torch.mm(g3, w3, out_dtype=_F32))


def _pad_rows(w: torch.Tensor, k: int, lead: int) -> torch.Tensor:
    """``w`` with ``k - rows`` zero rows after its first ``lead``."""
    if w.shape[0] == k:
        return w
    return torch.cat([w[:lead], w.new_zeros((k - w.shape[0], w.shape[1])), w[lead:]])


def _unpad_rows(dw: torch.Tensor, rows: int, lead: int) -> torch.Tensor:
    """``_pad_rows``' inverse: drop the padded rows of a cotangent."""
    if dw.shape[0] == rows:
        return dw
    return torch.cat([dw[:lead], dw[lead + dw.shape[0] - rows:]])


class _Bf16Trunk(torch.autograd.Function):
    """A trunk and its concatenated heads in a bf16 tier, forward and backward.

    ``apply(x, t, tier, skips, depth, grad, *params)``: ``params`` are the
    layers' ``w, b`` then the heads' ``w, b``, fp32; returns the heads' fp32
    outputs side by side.  Operand ``i`` of layer ``i`` (the heads' is
    operand ``depth``) is kept as bf16: operand 0 is ``[x | t]``, a skip
    layer's ``[x | h]``, the others ``h``.  ``grad`` is whether autograd
    records (it is off inside ``forward``): without it each operand is
    freed once used.  On the card ``[x | t]`` and ``x`` are padded to a
    multiple of 8 columns with zeros, and the weights with zero rows, so
    every row starts 16-byte aligned; a zero term adds nothing.

    Backward (see the module for the tiers): each hidden layer's cotangent
    leaves ``ops.kernels.trunk.relu_mask_bf16`` as bf16, exact in "bfloat16"
    (the cast's rounding) and rounded as the tier says in "bfloat16_bwd",
    with its bias's cotangent summed in the same pass, so every product but
    the heads' goes to the tensor cores.  The heads' incoming cotangent is
    fp32 and, in "bfloat16", is not rounded: its two products are exact
    (``_exact_heads``).  Weight cotangents, and those of ``x`` and ``t``, are
    rounded to bf16 in "bfloat16", as at the casts.
    """

    @staticmethod
    def forward(ctx, x, t, tier, skips, depth, grad, *params):
        n, s = x.shape
        pad = 8 if x.is_cuda else 1
        sp = -(-s // pad) * pad  # where h starts in a skip layer's operand
        fin = s + t.shape[1]
        k0 = -(-fin // pad) * pad
        ws, bs = params[0::2], params[1::2]
        width = ws[0].shape[1]

        a = x.new_empty((n, k0), dtype=_BF16)
        a[:, :s] = x
        a[:, s:fin] = t
        a[:, fin:] = 0
        keep = grad and any(ctx.needs_input_grad)
        acts, wbs = [a], []
        for i in range(depth + 1):
            if i == depth:  # the heads, side by side
                w, b = torch.cat(ws[depth:], dim=1), torch.cat(bs[depth:])
            else:
                w, b = ws[i], bs[i]
            wb = _pad_rows(w.to(_BF16), a.shape[1], fin if i == 0 else s)
            wbs.append(wb)
            y = _mm(a, wb)
            if i == depth:
                y += b
                break
            if i in skips:
                a = x.new_empty((n, sp + width), dtype=_BF16)
                a[:, :s] = acts[0][:, :s]
                a[:, s:sp] = 0
                trunk_kernels.bias_relu_bf16(y, b, a[:, sp:])
            else:
                a = trunk_kernels.bias_relu_bf16(y, b, x.new_empty((n, width), dtype=_BF16))
            del y
            if keep:
                acts.append(a)
        if keep:
            ctx.save_for_backward(*acts, *wbs)
        ctx.meta = (tier, tuple(skips), depth, s, sp, fin,
                    [w.shape[0] for w in ws[:depth + 1]], [w.shape[1] for w in ws[depth:]])
        return y

    @staticmethod
    def backward(ctx, g_out):
        tier, skips, depth, s, sp, fin, rows, head_dims = ctx.meta
        acts, wbs = ctx.saved_tensors[:depth + 1], ctx.saved_tensors[depth + 1:]
        rounds = tier == "bfloat16"

        def rnd(v):  # the bf16 rounding of a cotangent at a cast ("bfloat16" only)
            return v.to(_BF16).to(_F32) if rounds else v

        g_out = g_out.contiguous()
        if rounds:
            dw, da = _exact_heads(acts[depth], wbs[depth], g_out)
            dw = rnd(dw)
        else:
            gb = g_out.to(_BF16)
            dw = _mm(acts[depth].t(), gb)
            da = _mm(gb, wbs[depth].t())
        dw = _unpad_rows(dw, rows[depth], s)
        db = g_out.sum(0)
        head_grads = []
        for w, b in zip(dw.split(head_dims, dim=1), db.split(head_dims)):
            head_grads += [w, b]

        gx = None
        layer_grads = []
        for i in reversed(range(depth)):
            out = acts[i + 1]  # layer i's output: [x | 0 | h] after a skip, else h
            off = sp if i in skips else 0
            if i in skips:
                gx = rnd(da[:, :s]) if gx is None else gx + rnd(da[:, :s])
            gb = out.new_empty((out.shape[0], out.shape[1] - off))
            db = trunk_kernels.relu_mask_bf16(da[:, off:], out[:, off:], gb, rounded=rounds)
            dw = _unpad_rows(rnd(_mm(acts[i].t(), gb)), rows[i], fin if i == 0 else s)
            layer_grads = [dw, db, *layer_grads]
            da = _mm(gb, wbs[i].t()) if i or any(ctx.needs_input_grad[:2]) else None
        gt = None
        if da is not None:
            gx = rnd(da[:, :s]) if gx is None else rnd(da[:, :s]) + gx
            gt = rnd(da[:, s:fin])
        return (gx, gt, None, None, None, None, *layer_grads, *head_grads)


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
        if tier != "float32":
            params = [p for m in (*self.layers, *self.heads) for p in (m.w, m.b)]
            out = _Bf16Trunk.apply(x, t, tier, tuple(self.cfg.skips), len(self.layers),
                                   torch.is_grad_enabled(), *params)
            return tuple(torch.split(out, self.head_dims, dim=1))
        h = torch.cat([x, t], dim=-1)
        for i, layer in enumerate(self.layers):
            h = torch.relu(layer(h))
            if i in self.cfg.skips:
                h = torch.cat([x, h], dim=-1)
        wcat = torch.cat([hd.w for hd in self.heads], dim=1)
        bcat = torch.cat([hd.b for hd in self.heads], dim=0)
        out = h @ wcat + bcat
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
