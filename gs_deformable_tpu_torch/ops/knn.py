"""Mean squared distance to the 3 nearest neighbours of each point.

Port of ``gs_deformable_tpu/ops/knn.py``, used once at init to size the
gaussians (``models.gaussians.init_from_points``).  ``mean_sq_dist_knn3``
is the exact 3-NN: blocked all-pairs distances through the
``|x|^2 + |y|^2 - 2 <x, y>`` expansion (one fp32 matmul per block of query
rows, TF32 off) and a ``torch.topk``, with each point excluded by index,
so duplicate points count as neighbours at distance 0.  No kernel of the
JAX package runs here: it computes the same with ``jnp.matmul`` and
``lax.top_k``.  ``mean_sq_dist_knn3_window`` is the cheap approximation
over a window of Morton-order neighbours.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import device as device_rules


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of ``v`` (int64) to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """(N,) int64 30-bit Morton codes of the bbox-normalised points."""
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    rel = (points - lo) / torch.clamp(hi - lo, min=1e-12)
    q = torch.clamp(rel * 1023.0, 0, 1023).to(torch.int64)
    x, y, z = (_expand_bits(q[:, i]) for i in range(3))
    return x | (y << 1) | (z << 2)


BLOCK_ELEMENTS = 1 << 28  # one block's (rows, N) fp32 distances: 1 GiB


def block_rows(n: int, elements: int = BLOCK_ELEMENTS) -> int:
    """Query rows per block for an ``n``-point cloud: at most 4096, and
    at most ``elements`` distances a block."""
    return max(1, min(4096, elements // n))


def mean_sq_dist_knn3(points: torch.Tensor, block: Optional[int] = None) -> torch.Tensor:
    """Exact per-point mean of the squared distances to the 3 nearest other
    points.  ``points`` (N >= 4, 3) float32; returns (N,) float32.

    ``block`` query rows (default ``block_rows(N)``) go through one
    (block, N) distance matrix.
    """
    device_rules.pin_fp32()
    n = points.shape[0]
    block = block or block_rows(n)
    sq = (points * points).sum(dim=-1)
    cols = torch.arange(n, device=points.device)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        d2 = sq[s:e, None] + sq[None, :]
        d2.sub_((points[s:e] @ points.T).mul_(2.0))
        d2[torch.arange(e - s, device=points.device), cols[s:e]] = float("inf")
        top3 = torch.topk(d2, 3, dim=1, largest=False, sorted=False).values
        out[s:e] = torch.clamp(top3, min=0.0).mean(dim=-1)
    return out


def mean_sq_dist_knn3_window(points: torch.Tensor, window: int = 64) -> torch.Tensor:
    """Approximate: the exact top 3 among the ``window`` Morton-order
    neighbours on either side of each point.  (N,) float32."""
    n = points.shape[0]
    order = torch.argsort(morton_codes(points), stable=True)
    ps = points[order]
    dev = points.device
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    cand = torch.arange(n, device=dev)[:, None] + offsets[None, :]
    in_range = (cand >= 0) & (cand < n)
    diffs = ps[cand.clamp(0, n - 1)] - ps[:, None, :]
    d2 = torch.where(in_range, (diffs * diffs).sum(dim=-1), float("inf"))
    top3 = torch.topk(d2, 3, dim=1, largest=False).values
    finite = ~torch.isinf(top3)
    mean3 = (torch.where(finite, top3, 0.0).sum(-1)
             / torch.clamp(finite.sum(-1), min=1).to(points.dtype))
    return torch.zeros(n, dtype=points.dtype, device=dev).index_put_((order,), mean3)
