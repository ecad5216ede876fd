"""Dense reference rasterizer, the correctness oracle (port of
``gs_deformable_tpu/ops/rasterize_dense.py`` and its ``rasterize_types.py``).

An O(P x pixels) plain PyTorch walk with the compositing semantics of the
CUDA tile renderer (forward.cu:261-374 of the reference rasterizer), for
tests, scene building and card checks, never on the render or train path.
It shares no code with the tile path (binning, gather, composite kernels):

- gaussians are taken in (depth, emission order) order: a stable argsort;
- a gaussian touches only the pixels whose 16x16 *tile* lies inside its
  tile rect, even where its falloff reaches further;
- ``alpha = min(0.99, opacity * exp(power))``, skipped where ``power > 0``
  or ``alpha < 1/255`` (forward.cu:335-345);
- first-hit termination: a splat that is not skipped and would leave
  ``T * (1 - alpha) < 1e-4`` ends the pixel *without* contributing
  (forward.cu:346-351);
- the output is ``C + T * bg``, the final transmittance and the 1-based
  index, in the pixel's tile list, of the last contributing instance
  (``n_contrib``, forward.cu:367-373).

The 0.99 clamp is straight-through for gradients, as the reference backward
differentiates ``opacity * G`` without the clamp (backward.cu:500-505, 556),
so autograd through this oracle gives the reference's gradient convention.
``exp`` is taken of ``min(power, 0)``: where ``power > 0`` the splat is
skipped, so the value is unchanged, and an overflowing ``exp`` cannot turn
the masked-out branch's zero cotangent into NaN.

It runs where its tensors are: every state tensor is made on the device of
``means2d_pix``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RasterizeConfig

_RASTER = RasterizeConfig()


class CompositeParams(NamedTuple):
    """Compositing constants (config.h:16-17, forward.cu:343-347), with the
    defaults of ``config.RasterizeConfig``."""

    tile_x: int = _RASTER.tile_x
    tile_y: int = _RASTER.tile_y
    alpha_max: float = _RASTER.alpha_max
    alpha_min: float = _RASTER.alpha_min
    transmittance_eps: float = _RASTER.transmittance_eps


class DenseRenderOut(NamedTuple):
    color: torch.Tensor  # (3, H, W), composited over bg
    final_t: torch.Tensor  # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32


def _straight_through_min(x: torch.Tensor, cap: float) -> torch.Tensor:
    """min(x, cap) in the forward, the identity in the backward."""
    return x + (x.clamp(max=cap) - x).detach()


def rasterize_dense(means2d_pix, depths, conics, opacities, colors, rect, mask, bg, *,
                    width: int, height: int,
                    params: CompositeParams = CompositeParams()) -> DenseRenderOut:
    """Composite every gaussian over the whole image, one at a time in depth order.

    Args:
      means2d_pix: (P, 2) pixel-space centres.
      depths: (P,) view-space z, the sort key.
      conics: (P, 3) inverse 2D covariances (A, B, C).
      opacities: (P,) activated opacity.
      colors: (P, 3) RGB after SH evaluation.
      rect: (P, 4) int tile rect [x0, y0, x1, y1).
      mask: (P,) bool visibility.
      bg: (3,) background colour.
    """
    dev = means2d_pix.device
    tx, ty = params.tile_x, params.tile_y
    # Stable depth sort: the reference's radix sort over [tile | depth] keys
    # keeps emission order among equal depths (rasterizer_impl.cu:300-308).
    order = torch.argsort(depths, stable=True)
    xy, con, op, col = means2d_pix[order], conics[order], opacities[order], colors[order]
    rc, live = rect[order], mask[order]

    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, :]  # (1, W)
    ys = torch.arange(height, dtype=torch.float32, device=dev)[:, None]  # (H, 1)
    tile_col = (torch.arange(width, dtype=torch.int32, device=dev) // tx)[None, :]
    tile_row = (torch.arange(height, dtype=torch.int32, device=dev) // ty)[:, None]

    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    C = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    count = torch.zeros((height, width), dtype=torch.int32, device=dev)
    last = torch.zeros((height, width), dtype=torch.int32, device=dev)
    for i in range(xy.shape[0]):
        r = rc[i]
        in_rect = ((tile_col >= r[0]) & (tile_col < r[2]) & (tile_row >= r[1])
                   & (tile_row < r[3]) & live[i])
        dx = xy[i, 0] - xs
        dy = xy[i, 1] - ys
        power = -0.5 * (con[i, 0] * dx * dx + con[i, 2] * dy * dy) - con[i, 1] * dx * dy
        alpha = _straight_through_min(op[i] * torch.exp(power.clamp(max=0.0)), params.alpha_max)
        skip = (power > 0.0) | (alpha < params.alpha_min) | ~in_rect
        test_t = T * (1.0 - alpha)
        live_px = ~skip & ~done
        newly_done = live_px & (test_t < params.transmittance_eps)
        contrib = live_px & ~newly_done

        C = C + torch.where(contrib, alpha * T, 0.0)[None] * col[i][:, None, None]
        T = torch.where(contrib, test_t, T)
        done = done | newly_done
        # The 1-based instance counter of the pixel's tile list: every in-rect
        # instance counts (forward.cu:325-328); n_contrib is the last
        # contributing one's.
        count = count + in_rect.to(torch.int32)
        last = torch.where(contrib, count, last)

    color = C + T[None] * bg[:, None, None]
    return DenseRenderOut(color=color, final_t=T, n_contrib=last)
