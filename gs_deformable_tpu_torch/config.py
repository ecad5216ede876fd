"""Typed configuration of the PyTorch port: the JAX package's config tree,
copied with the same fields and defaults so a config built for one package
reads the same in the other.

Knobs split two ways in this port:

- implemented: everything the deformable render path, the training step
  and the mesh (``parallel``: data and model axes over torch.distributed
  ranks) read, ``grad_reduce``, ``bf16_cotangents`` and the packed knobs
  (``composite_mode="packed"``, ``sort_mode="packed"``, ``sub_chunk``)
  included;
- documented no-ops: knobs that only shaped the TPU schedule (``tile_batch``,
  ``stream_chunks``, ``scan_mode``, ``defer_fwd_reductions``, ``block_rows``,
  ``fill_mode``).  The CUDA kernels compute the same values whatever they
  are set to.  So are ``pipeline.convert_shs_python`` and
  ``pipeline.compute_cov3d_python``: the port always computes the SH colours
  and cov3D inside ``ops.rasterize.screen_space``.

``check_supported`` raises ``ValueError`` for a value no package takes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    # "offset" (the 4-head additive net), "se3" (per-gaussian rigid
    # transforms of the means) or "none" (static scene).
    deform_mode: str = "offset"
    use_opacity_mask: bool = False
    random_init_points: int = 100_000


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    depth: int = 8
    width: int = 256
    skips: Tuple[int, ...] = (4,)
    multires_xyz: int = 10
    multires_time: int = 10
    warmup_iters: int = 3000
    sh_coeffs: int = 16
    # "bfloat16": operands rounded to bf16, products summed in fp32 (the
    # JAX tier's preferred_element_type=float32).  "float32": full fp32.
    # "float32_3x" (the TPU's 3-pass bf16 tier, ~1e-6 relative) runs as
    # "float32" here.
    compute_dtype: str = "bfloat16"
    # bfloat16 tier only: True rounds each layer's cotangent to bf16 before
    # both transposed products (fp32 sums), as the JAX _bf16_mm backward.
    bf16_cotangents: bool = False
    block_rows: int = 65536  # TPU code-size knob; no-op in this port


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    convert_shs_python: bool = False
    compute_cov3d_python: bool = False
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    tile_x: int = 16
    tile_y: int = 16
    instance_capacity: int = 1 << 21
    # Tile alignment of the instance layout (``sub_chunk`` under "packed",
    # see ``layout_unit``).  The CUDA composite streams any alignment; it
    # only sets where each tile's rows start.
    chunk: int = 128
    tile_batch: int = 8  # TPU grid batching; no-op in this port
    opacity_aware_radius: bool = True
    tile_cull: bool = True
    # "mixed", "batch", "stream" and "packed" compute one function and all
    # run the tile-composite forward and backward kernels; "packed" lays
    # each tile out at ``sub_chunk`` rows instead of ``chunk``.
    composite_mode: str = "mixed"
    sub_chunk: int = 32  # must divide chunk under "packed"
    stream_chunks: int = 8  # TPU stream schedule; no-op in this port
    aligned_slack: int = -1
    # "exact", and "auto"/"radix" which give the same order by construction;
    # "packed": one (tile, top 19 depth bits) key over the instances in
    # gaussian-index order, so depths within ~0.1% of each other keep that
    # order, and an overflow drops the highest indices, not the deepest.
    sort_mode: str = "auto"
    # Every value gives the same integers; the port always fills through
    # the ordered-fill kernel.
    fill_mode: str = "pallas_all"
    scan_mode: str = "linear"  # TPU prefix-product form; no-op in this port
    # Per-gaussian sum of the composite's gradient rows: "sort" (stable sort
    # + segmented sum, deterministic) or "scatter" (index_add_).
    grad_reduce: str = "sort"
    defer_fwd_reductions: bool = False  # TPU reduction schedule; no-op
    transmittance_eps: float = 1e-4
    alpha_max: float = 0.99
    alpha_min: float = 1.0 / 255.0


@dataclasses.dataclass(frozen=True)
class OptimizationConfig:
    iterations: int = 40_000
    position_lr_init: float = 1.6e-4
    position_lr_final: float = 1.6e-6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 40_000
    offset_lr_init: float = 8e-4
    offset_lr_final: float = 1.6e-6
    feature_lr: float = 2.5e-3
    opacity_lr: float = 0.05
    scaling_lr: float = 5e-3
    rotation_lr: float = 1e-3
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    lambda_offset_norm: float = 0.1
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 2e-4
    min_opacity: float = 0.005
    max_screen_size: int = 20
    densify_offset_gate: float = 0.0
    adam_eps: float = 1e-15
    adam_b1: float = 0.9
    adam_b2: float = 0.999


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data_axis: int = 1
    model_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    deform: DeformConfig = dataclasses.field(default_factory=DeformConfig)
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    raster: RasterizeConfig = dataclasses.field(default_factory=RasterizeConfig)
    opt: OptimizationConfig = dataclasses.field(default_factory=OptimizationConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def layout_unit(cfg: RasterizeConfig) -> int:
    """Rows each tile's instance range is aligned to: ``sub_chunk`` under
    ``composite_mode="packed"``, else ``chunk`` (rasterize.py:97-99 of the
    JAX package).  Every aligned capacity Kp of the port comes from it."""
    return cfg.sub_chunk if cfg.composite_mode == "packed" else cfg.chunk


def check_raster(cfg: RasterizeConfig) -> None:
    """Raise for rasterizer knobs this port does not take."""
    if cfg.composite_mode not in ("mixed", "batch", "stream", "packed"):
        raise ValueError(f"unknown composite_mode {cfg.composite_mode!r}")
    if cfg.composite_mode == "packed" and (cfg.sub_chunk < 1 or cfg.chunk % cfg.sub_chunk):
        # packed_composite.py:494 asserts it.
        raise ValueError(f"composite_mode='packed' needs sub_chunk ({cfg.sub_chunk}) to "
                         f"divide chunk ({cfg.chunk})")
    if cfg.sort_mode not in ("exact", "auto", "radix", "packed"):
        raise ValueError(f"unknown sort_mode {cfg.sort_mode!r}")
    if cfg.fill_mode not in ("scatter", "pallas", "pallas_all"):
        raise ValueError(f"unknown fill_mode {cfg.fill_mode!r}")
    if cfg.grad_reduce not in ("sort", "scatter"):
        raise ValueError(f"unknown grad_reduce {cfg.grad_reduce!r}")


def check_supported(cfg: Config) -> None:
    """Raise ``ValueError`` for a knob value of ``cfg`` that no package takes."""
    check_raster(cfg.raster)
    if cfg.model.deform_mode not in ("offset", "se3", "none"):
        raise ValueError(f"unknown deform_mode {cfg.model.deform_mode!r}")
    if cfg.parallel.data_axis < 1 or cfg.parallel.model_axis < 1:
        raise ValueError(f"parallel data_axis {cfg.parallel.data_axis} / model_axis "
                         f"{cfg.parallel.model_axis} must be at least 1")
    if cfg.deform.compute_dtype not in ("bfloat16", "float32", "float32_3x"):
        raise ValueError(
            f"unknown deform.compute_dtype {cfg.deform.compute_dtype!r}")
