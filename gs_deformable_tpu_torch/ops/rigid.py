"""Batched SE(3)/SO(3) exponential maps (port of ``gs_deformable_tpu/ops/rigid.py``).

The SE(3) deformation variant (``models.deform.deform_se3``) predicts a
screw (w, v) per gaussian and integrates it into a 4x4 rigid transform.

The JAX package computes its 3x3 products at ``Precision.HIGHEST``.  Here
they are written out elementwise, so they are full fp32 on every device
whatever the matmul settings (no TF32).  The formulas keep their
``(1 - cos θ)`` and ``(θ - sin θ)`` forms: a Taylor-stabilised form would
give another result than the reference at small θ, not the same one more
accurately.
"""

from __future__ import annotations

import torch


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) x (..., k, j) as an elementwise fp32 product and sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
    ], dim=-2)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: unit axes w (..., 3), angles theta (...,) -> (..., 3, 3)."""
    W = skew(w)
    th = theta[..., None, None]
    return _eye(W) + torch.sin(th) * W + (1.0 - torch.cos(th)) * _mm(W, W)


def rp_to_se3(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotation (..., 3, 3) and translation (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([R, p[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(R.shape[:-2] + (1, 4))], dim=-2)


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Screw axes S (..., 6) = [w, v] with |w| = 1, magnitudes theta (...,)
    -> rigid transforms (..., 4, 4)."""
    w, v = S[..., :3], S[..., 3:]
    W = skew(w)
    R = exp_so3(w, theta)
    th = theta[..., None, None]
    V = th * _eye(W) + (1.0 - torch.cos(th)) * W + (th - torch.sin(th)) * _mm(W, W)
    p = (V * v[..., None, :]).sum(dim=-1)
    return rp_to_se3(R, p)


def to_homogenous(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 4) with a trailing 1."""
    return torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)


def from_homogenous(v: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3), the perspective divide."""
    return v[..., :3] / v[..., -1:]
