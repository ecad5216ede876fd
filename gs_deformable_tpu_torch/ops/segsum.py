"""Sorted-splat gather and its per-gaussian gradient reduction.

Port of ``gs_deformable_tpu/ops/segsum.py``.  The composite reads the
``(P, 16)`` screen-space splat table through the field-major sorted layout
``splats[gid].T``; the gather's gradient is the per-gaussian sum of each
aligned instance slot's ``(Kp, 16)`` gradient row, selected by
``grad_reduce``:

- ``"sort"`` (default): deterministic.  A stable sort of ``gid`` groups each
  gaussian's rows in slot order, and a segmented sum
  (``torch.segment_reduce``) adds only those rows, in fp32.  It never takes
  differences of a global prefix sum, whose cancellation error grows with
  the running total (segsum.py:18-27 of the JAX package records that this
  broke the rtol-1e-4 bar).
- ``"scatter"``: ``index_add_`` (on the card its float atomics add in no
  fixed order).

The JAX package does this reduction in XLA, not Pallas, so plain PyTorch is
the port.
"""

from __future__ import annotations

import torch

GRAD_REDUCE = ("sort", "scatter")
# Rows that are exactly zero go to this many spare segments past the last
# gaussian, which are dropped (see segment_sum_rows).
SPARE_SEGMENTS = 4096


def segment_sum_rows(rows: torch.Tensor, gid: torch.Tensor, P: int) -> torch.Tensor:
    """Sum ``(Kp, C)`` rows into ``(P, C)`` by gaussian id, deterministically.

    Each gaussian's total is a sequential fp32 sum of its own nonzero rows in
    slot order; a gaussian with no rows gets 0.  An exactly-zero row adds
    nothing (x + 0 == x), so it is left out: the layout's padding slots all
    carry gaussian 0 and would otherwise form one segment of ~Kp/2 rows,
    which the segmented sum walks serially (20.8 ms at the 800x800 train
    frame on an H100).  Zero rows are spread over ``SPARE_SEGMENTS``
    short segments that are dropped, so nothing synchronises with the host.
    """
    slot = torch.arange(rows.shape[0], device=rows.device)
    key = torch.where((rows != 0).any(dim=1), gid.long(), P + slot % SPARE_SEGMENTS)
    order = torch.sort(key, stable=True).indices
    lengths = torch.bincount(key, minlength=P + SPARE_SEGMENTS)
    sums = torch.segment_reduce(rows.index_select(0, order), "sum", lengths=lengths, axis=0)
    return torch.where((lengths[:P] > 0)[:, None], sums[:P], 0.0)


def scatter_sum_rows(rows: torch.Tensor, gid: torch.Tensor, P: int) -> torch.Tensor:
    """``zeros(P, C).index_add_(0, gid, rows)``: the ``"scatter"`` reduction."""
    out = torch.zeros((P, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return out.index_add_(0, gid.long(), rows)


class GatherSplatsT(torch.autograd.Function):
    """``apply(splats (P, 16), gid (Kp,), grad_reduce)`` -> ``(16, Kp)``
    ``splats[gid].T``; the gradient of ``splats`` is the per-gaussian sum of
    the ``(Kp, 16)`` gradient rows (see module)."""

    @staticmethod
    def forward(ctx, splats, gid, grad_reduce):
        if grad_reduce not in GRAD_REDUCE:
            raise ValueError(f"unknown grad_reduce {grad_reduce!r}")
        ctx.save_for_backward(gid)
        ctx.num_gaussians = splats.shape[0]
        ctx.grad_reduce = grad_reduce
        return gather_splats_t(splats, gid)

    @staticmethod
    def backward(ctx, grad):
        (gid,) = ctx.saved_tensors
        reduce = segment_sum_rows if ctx.grad_reduce == "sort" else scatter_sum_rows
        return reduce(grad.t().contiguous(), gid, ctx.num_gaussians), None, None


def gather_splats_t(splats: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(P, 16) splats -> field-major (16, Kp) sorted layout ``splats[gid].T``."""
    return splats.index_select(0, gid.long()).t().contiguous()
