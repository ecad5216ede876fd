"""Training steps of a cell in plain PyTorch: the loss of deformable 3D
gaussian splatting and Adam on every parameter group and the net.

loss = (1 - 0.2) (L1 + 0.1 mean_alive |dx|) + 0.2 (1 - SSIM), SSIM with an
11-tap gaussian window of sigma 1.5, zero padding and C1 = 0.01^2,
C2 = 0.03^2.  Adam in torch's form (bias-corrected moments, eps outside the
root), one learning rate a group: xyz and the net decay log-linearly over
40,000 iterations, the rest are constants (3DGS's and the deformable
reference's training arguments).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import render as R

GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
B1, B2, EPS = 0.9, 0.999, 1e-15
LAMBDA_DSSIM = 0.2
LAMBDA_OFFSET = 0.1
MAX_STEPS = 40_000


def expon(step: int, init: float, final: float) -> float:
    t = min(max(step / MAX_STEPS, 0.0), 1.0)
    return math.exp(math.log(init) * (1 - t) + math.log(final) * t)


def learning_rates(iteration: int, extent: float) -> Dict[str, float]:
    return {"xyz": expon(iteration, 1.6e-4 * extent, 1.6e-6 * extent),
            "net": expon(iteration, 8e-4, 1.6e-6),
            "f_dc": 2.5e-3, "f_rest": 2.5e-3 / 20.0, "opacity": 0.05, "scaling": 5e-3,
            "rotation": 1e-3}


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xs = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-xs * xs / (2 * 1.5 ** 2))
    g = (g / g.sum()).float().to(a.device)
    win = (g[:, None] * g[None, :]).expand(3, 1, 11, 11).contiguous()

    def blur(x):
        return F.conv2d(x[None], win, padding=5, groups=3)[0]

    mu1, mu2 = blur(a), blur(b)
    s11 = blur(a * a) - mu1 * mu1
    s22 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def loss_of(img: torch.Tensor, gt: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    sq = (dx * dx).sum(-1)
    nz = sq > 0
    offset = (torch.sqrt(torch.where(nz, sq, 1.0)) * nz).mean()
    l1 = (img - gt).abs().mean()
    return (1 - LAMBDA_DSSIM) * (l1 + LAMBDA_OFFSET * offset) + LAMBDA_DSSIM * (1 - ssim(img, gt))


def leaves(g: Dict[str, torch.Tensor], nets: dict) -> Dict[str, torch.Tensor]:
    """Every trained tensor by name: the six groups, then the net's layers
    and heads (the gate is not trained)."""
    out = dict(g)
    for part in ("layers", "heads"):
        for i, layer in enumerate(nets["net"][part]):
            for k in ("w", "b"):
                out[f"net.{part}.{i}.{k}"] = layer[k]
    return out


def _nets_of(flat: Dict[str, torch.Tensor], nets: dict) -> dict:
    net = {part: [{k: flat[f"net.{part}.{i}.{k}"] for k in ("w", "b")}
                  for i in range(len(nets["net"][part]))] for part in ("layers", "heads")}
    return {**nets, "net": net}


def steps(config: dict, nets: dict, g: Dict[str, torch.Tensor], views: List[dict],
          gts: List[torch.Tensor], iterations: List[int], extent: float, bg: torch.Tensor,
          prec: R.Precision) -> dict:
    """Train steps from the gaussians ``g`` and ``nets``, step i on
    ``views[i]`` against ``gts[i]`` at ``iterations[i]``, from zero Adam
    moments.  Returns each step's ``losses``, the first step's gradient of
    every leaf (``grads``) and every leaf after the last step (``params``)."""
    R.pin_fp32()
    p = {k: v.detach().clone() for k, v in leaves(g, nets).items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first = [], None
    for step, (view, gt, it) in enumerate(zip(views, gts, iterations), start=1):
        x = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        img, dx = R.render(config, _nets_of(x, nets), {k: x[k] for k in GROUPS}, view, bg,
                           prec)
        loss = loss_of(img, gt, dx)
        grads = dict(zip(x, torch.autograd.grad(loss, list(x.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(p[k]) if gr is None else gr for k, gr in grads.items()}
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        lrs = learning_rates(it, extent)
        with torch.no_grad():
            for k in p:
                lr = lrs["net" if k.startswith("net.") else k]
                m[k] = B1 * m[k] + (1 - B1) * grads[k]
                v2[k] = B2 * v2[k] + (1 - B2) * grads[k] * grads[k]
                mhat = m[k] / (1 - B1 ** step)
                vhat = v2[k] / (1 - B2 ** step)
                p[k] = p[k] - lr * mhat / (torch.sqrt(vhat) + EPS)
    return {"losses": losses, "grads": first, "params": p}
