"""The differentiable tiled rasterizer: preprocess -> tile cull -> binning ->
CUDA composite.

Port of ``gs_deformable_tpu/ops/rasterize.py``.  Preprocess and SH colour
(``screen_space``) are one CUDA kernel each way on the card
(``ops/kernels/screen_space.py``) and plain PyTorch under autograd on the
CPU; binning is integer bookkeeping with no gradient; the sorted-splat
gather (``GatherSplatsT``) and the composite (``Composite``, forward and
backward CUDA kernels) carry their own backward, so ``means2d_pix``,
``conics``, ``opacities`` and ``colors`` get gradients as in the JAX
version.  Every ``composite_mode`` ("mixed", "batch", "stream",
"packed") runs the same two kernels: the JAX
schedules compute the same function.  "packed" only aligns each tile's
instance range to ``sub_chunk`` rows instead of ``chunk``
(``config.layout_unit``), which shrinks the layout; the kernels read
exactly each tile's range wherever it starts.  ``stream_chunks`` and
``scan_mode`` shape only the TPU schedules and are no-ops here: the JAX
packed kernel forces its log-space scan (rasterize.py:151-154 of the JAX
package), while the port keeps the sequential transmittance of the CUDA
reference under every mode.

Gradient tap: ``render_gaussians`` takes ``means2d_offset_ndc``, a zeros
``(P, 2)`` tensor added to the NDC means; its gradient is dL/d(ndc mean2D),
which densification consumes (rasterize.py:16-21 of the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..config import RasterizeConfig, check_raster, layout_unit
from .binning import bin_gaussians
from .kernels import screen_space as screen_space_ops
from .kernels.composite import SPLAT_WIDTH, Composite
from .projection import PreprocessOut, tile_ellipse_mask
from .segsum import GatherSplatsT


class RenderOut(NamedTuple):
    image: torch.Tensor  # (3, H, W) composited over bg
    final_t: torch.Tensor  # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32
    radii: torch.Tensor  # (P,) int32
    means2d_ndc: torch.Tensor  # (P, 2)
    visibility: torch.Tensor  # (P,) bool
    required_instances: torch.Tensor  # () int32; overflow if > instance_capacity
    required_aligned: torch.Tensor  # () int32 aligned rows needed (vs Kp)


def prepare_tiles(means2d_pix, depths, conics, opacities, colors, rect, tiles_touched,
                  *, grid_x: int, grid_y: int, cfg: RasterizeConfig = RasterizeConfig()):
    """Tile cull -> bin -> sorted-splat gather: (splats_t (16, Kp), Binning).

    The binning is aligned to ``layout_unit(cfg)`` rows, and so is Kp.

    ``splats_t`` carries a gradient to the screen-space inputs (reduced per
    gaussian by ``cfg.grad_reduce``).  While tracing is on (``tracing``), the
    counters ``binning.kp_rows`` and ``binning.needed_rows`` take Kp and the
    aligned rows the frame needed (``Binning.total_aligned``).
    """
    with tracing.span("gs.binning"):
        check_raster(cfg)
        if (cfg.tile_x, cfg.tile_y) != (16, 16):
            raise ValueError("the composite kernel takes 16x16 tiles")
        tt = tiles_touched
        tile_mask = None
        if cfg.tile_cull:
            with torch.no_grad():
                tile_mask, tt = tile_ellipse_mask(means2d_pix, conics, opacities, rect, tt,
                                                  tile_x=cfg.tile_x, tile_y=cfg.tile_y)
        binning = bin_gaussians(tt, rect, depths.detach(), grid_x=grid_x, grid_y=grid_y,
                                capacity=cfg.instance_capacity, chunk=layout_unit(cfg),
                                sort_mode=cfg.sort_mode, aligned_slack=cfg.aligned_slack,
                                tile_mask=tile_mask)
        tracing.count("binning.kp_rows", binning.gid.shape[0])
        tracing.count("binning.needed_rows", binning.total_aligned)
        P = means2d_pix.shape[0]
        op = opacities[:, None] if opacities.dim() == 1 else opacities
        splats = torch.cat(
            [means2d_pix, conics, op, colors,
             torch.zeros((P, SPLAT_WIDTH - 9), dtype=torch.float32, device=means2d_pix.device)],
            dim=1)
        return GatherSplatsT.apply(splats, binning.gid, cfg.grad_reduce), binning


def composite_tiles(means2d_pix, depths, conics, opacities, colors, rect, tiles_touched,
                    *, grid_x: int, grid_y: int, cfg: RasterizeConfig = RasterizeConfig()):
    """Tile cull -> bin -> sorted-splat gather -> composite on a (grid_x, grid_y) grid.

    Differentiable.  Returns (out_tiles (T, 8, 256), required int32,
    total_aligned int32).
    """
    splats_t, binning = prepare_tiles(means2d_pix, depths, conics, opacities, colors, rect,
                                      tiles_touched, grid_x=grid_x, grid_y=grid_y, cfg=cfg)
    with tracing.span("gs.composite"):
        out_tiles = Composite.apply(
            splats_t, binning.tile_chunk_start, binning.tile_count, grid_x, layout_unit(cfg),
            cfg.alpha_max, cfg.alpha_min, cfg.transmittance_eps)
    return out_tiles, binning.required, binning.total_aligned


def tiles_to_image(tiles, *, grid_x: int, width: int, height: int, cfg: RasterizeConfig):
    """(T, C, npix) tiles in row-major order -> (C, H, W), cropped to H x W."""
    gy, c = tiles.shape[0] // grid_x, tiles.shape[1]
    x = tiles.reshape(gy, grid_x, c, cfg.tile_y, cfg.tile_x).permute(2, 0, 3, 1, 4)
    return x.reshape(c, gy * cfg.tile_y, grid_x * cfg.tile_x)[:, :height, :width]


def rasterize_arrays(means2d_pix, depths, conics, opacities, colors, rect, tiles_touched,
                     bg, *, width: int, height: int,
                     cfg: RasterizeConfig = RasterizeConfig()):
    """Composite screen-space gaussians over ``bg`` (differentiable).

    Returns (image (3,H,W), final_t (H,W), n_contrib (H,W) int32, required,
    total_aligned).
    """
    grid_x = (width + cfg.tile_x - 1) // cfg.tile_x
    grid_y = (height + cfg.tile_y - 1) // cfg.tile_y
    out_tiles, required, total_aligned = composite_tiles(
        means2d_pix, depths, conics, opacities, colors, rect, tiles_touched,
        grid_x=grid_x, grid_y=grid_y, cfg=cfg)
    planes = tiles_to_image(out_tiles[:, 0:5], grid_x=grid_x, width=width, height=height, cfg=cfg)
    final_t = planes[3]
    n_contrib = planes[4].detach().to(torch.int32)
    image = planes[0:3] + final_t[None] * bg[:, None, None]
    return image, final_t, n_contrib, required, total_aligned


class ScreenSpace(NamedTuple):
    pre: PreprocessOut
    means2d_pix: torch.Tensor  # (P, 2) after the NDC tap offset
    means2d_ndc: torch.Tensor  # (P, 2)
    colors: torch.Tensor  # (P, 3)
    opacities: torch.Tensor  # (P,)


def screen_space(means3d, scales, rotations, opacities, shs, *, viewmatrix, projmatrix,
                 campos, width: int, height: int, tan_fovx: float, tan_fovy: float,
                 sh_degree: int, scale_modifier: float = 1.0,
                 alive: Optional[torch.Tensor] = None,
                 means2d_offset_ndc: Optional[torch.Tensor] = None,
                 colors_precomp: Optional[torch.Tensor] = None,
                 cov3d_precomp: Optional[torch.Tensor] = None,
                 cfg: RasterizeConfig = RasterizeConfig()) -> ScreenSpace:
    """cov3D -> EWA preprocess -> SH colour: the per-gaussian half of the render.

    CUDA tensors take one kernel launch each way (``ScreenSpaceFn``, which
    refuses a camera that wants a gradient); CPU tensors and precomputed
    colours or covariances take the plain chain
    (``screen_space_ops.forward_plain``).
    """
    with tracing.span("gs.screen_space"):
        op = opacities[:, 0] if opacities.dim() == 2 else opacities
        kw = dict(width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                  sh_degree=sh_degree, scale_modifier=scale_modifier, tile_x=cfg.tile_x,
                  tile_y=cfg.tile_y)
        radius_op = op if cfg.opacity_aware_radius else None
        camera = (viewmatrix, projmatrix, campos)
        if (means3d.device.type == "cpu" or colors_precomp is not None
                or cov3d_precomp is not None):
            out = screen_space_ops.forward_plain(
                means3d, scales, rotations, shs, *camera, opacities=radius_op, alive=alive,
                tap=means2d_offset_ndc, cov3d_precomp=cov3d_precomp,
                colors_precomp=colors_precomp, **kw)
        else:
            out = screen_space_ops.ScreenSpaceFn.apply(
                means3d, scales, rotations, shs, means2d_offset_ndc, *camera,
                None if radius_op is None else radius_op.detach(), alive, kw)
        ndc, pix, depths, conics, colors, radii, rect, tiles, mask = out[:9]
        pre = PreprocessOut(ndc, pix, depths, conics, radii, rect, tiles, mask)
        if means2d_offset_ndc is not None:
            ndc, pix = out[9:11]
        return ScreenSpace(pre, pix, ndc, colors, op)


def render_gaussians(means3d, scales, rotations, opacities, shs, *, bg, width: int,
                     height: int, cfg: RasterizeConfig = RasterizeConfig(),
                     **kw) -> RenderOut:
    """Render activated 3D gaussians: ``screen_space`` (same keywords) then the
    tiled composite over ``bg``."""
    ss = screen_space(means3d, scales, rotations, opacities, shs, width=width,
                      height=height, cfg=cfg, **kw)
    pre = ss.pre
    image, final_t, n_contrib, required, total_aligned = rasterize_arrays(
        ss.means2d_pix, pre.depths, pre.conics, ss.opacities, ss.colors, pre.rect,
        pre.tiles_touched, bg, width=width, height=height, cfg=cfg)
    return RenderOut(image, final_t, n_contrib, pre.radii, ss.means2d_ndc, pre.radii > 0,
                     required, total_aligned)
