"""Sorted-splat gather (port of the forward of ``ops/segsum.py:gather_splats_t``).

The segment-sum gradient of the gather arrives with the training slice.
"""

from __future__ import annotations

import torch


def gather_splats_t(splats: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """(P, 16) splats -> field-major (16, Kp) sorted layout ``splats[gid].T``."""
    return splats.index_select(0, gid.long()).t().contiguous()
