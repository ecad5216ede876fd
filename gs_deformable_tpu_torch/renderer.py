"""Render orchestration: deformation + activations + tiled rasterizer.

Port of ``gs_deformable_tpu/renderer.py``.  ``render`` is differentiable
end to end (the training step takes gradients through it); eval callers
wrap it in ``torch.no_grad()`` (``training.make_eval_render``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from . import device as device_rules
from . import tracing
from .config import Config, check_supported
from .models import deform as deform_mod
from .models.gaussians import GaussianState
from .ops.rasterize import RenderOut, render_gaussians


class CameraArrays(NamedTuple):
    world_view: torch.Tensor  # (4, 4) row-vector world -> view
    full_proj: torch.Tensor  # (4, 4) row-vector world -> clip
    camera_center: torch.Tensor  # (3,)
    time: torch.Tensor  # ()

    @classmethod
    def from_numpy(cls, world_view, full_proj, camera_center, time, device="cuda"):
        dev = device_rules.resolve(device)

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        return cls(f32(world_view), f32(full_proj), f32(camera_center), f32(time))


def deformed_attributes(state: GaussianState, net: Optional[deform_mod.DeformMLP],
                        time, iteration: int, cfg: Config,
                        latent: Optional[Dict[str, deform_mod.DeformMLP]] = None):
    """Activated per-gaussian attributes after the deformation, plus the raw dx.

    ``net`` is the ``OffsetNet`` under ``deform_mode="offset"``, the
    ``SE3Net`` under "se3" (it moves the means only; dx is the move) and
    None under "none".  With ``cfg.model.use_opacity_mask`` and the latent
    heads given, ``sigmoid(opacity)`` is multiplied by their opacity gate.

    Dead capacity slots are routed to finite constants (means 1e6, scales
    1e-6, identity rotation, opacity 0, zero SH and offsets) by
    ``torch.where``, as the JAX version does: the where also gives every
    dead slot an exactly-zero gradient, so a NaN reached on a dead slot's
    backward path never reaches the MLP's shared weights.

    While tracing is on (``tracing``), the counters ``deform.rows`` and
    ``deform.live_rows`` take the rows each net and the gate ran over and
    the alive ones among them.
    """
    xyz = state.xyz
    n = xyz.shape[0]
    mode = cfg.model.deform_mode
    if mode == "offset":
        if cfg.deform.sh_coeffs != (cfg.model.sh_degree + 1) ** 2:
            raise ValueError(
                f"deform.sh_coeffs ({cfg.deform.sh_coeffs}) must equal "
                f"(sh_degree+1)^2 = {(cfg.model.sh_degree + 1) ** 2}")
        dx, d_scale, d_rot, d_shs = deform_mod.deform_offsets(
            net, xyz, time, iteration, cfg.deform)
        means3d = xyz + dx
        scales = torch.exp(state.scaling + d_scale)
        rot = state.rotation + d_rot
        rotations = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=-1, keepdim=True),
                                      min=1e-12)
        shs = state.get_features() + d_shs.reshape(n, cfg.deform.sh_coeffs, 3)
    elif mode == "se3":
        means3d = deform_mod.deform_se3(net, xyz, time, iteration, cfg.deform)
        dx = means3d - xyz
        scales = state.get_scaling()
        rotations = state.get_rotation()
        shs = state.get_features()
    elif mode == "none":
        means3d = xyz
        dx = torch.zeros_like(xyz)
        scales = state.get_scaling()
        rotations = state.get_rotation()
        shs = state.get_features()
    else:
        raise NotImplementedError(f"deform_mode {mode!r} (see config.check_supported)")

    opacity = state.get_opacity()
    if cfg.model.use_opacity_mask and latent is not None:
        opacity = opacity * deform_mod.opacity_mask_gate(latent, xyz, time, iteration,
                                                         cfg.deform)
    if int(iteration) >= cfg.deform.warmup_iters:
        nets = (mode != "none") + (cfg.model.use_opacity_mask and latent is not None)
        if nets:
            tracing.count("deform.rows", nets * n)
            tracing.count_set("deform.live_rows", state.alive, nets)
    a1 = state.alive[:, None]
    means3d = torch.where(a1, means3d, 1e6)
    scales = torch.where(a1, scales, 1e-6)
    rotations = torch.where(a1, rotations, torch.tensor([1.0, 0.0, 0.0, 0.0],
                                                        device=xyz.device))
    opacity = torch.where(a1, opacity, 0.0)
    shs = torch.where(a1[:, :, None], shs, 0.0)
    dx = torch.where(a1, dx, 0.0)
    return means3d, scales, rotations, opacity, shs, dx


def render(state: GaussianState, net: Optional[deform_mod.DeformMLP], camera: CameraArrays,
           *, iteration: int, bg: torch.Tensor, width: int, height: int,
           tan_fovx: float, tan_fovy: float, active_sh_degree: int, cfg: Config,
           scale_modifier: float = 1.0,
           means2d_offset_ndc: Optional[torch.Tensor] = None,
           latent: Optional[Dict[str, deform_mod.DeformMLP]] = None,
           device="cuda") -> tuple:
    """Render one frame; returns (RenderOut, dx offsets).  Differentiable.

    ``net`` and ``latent`` as in ``deformed_attributes``.

    Every tensor must lie on ``device`` (default ``"cuda"``; a missing GPU
    raises).  Sets ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False before it runs, so every
    fp32 matmul is full fp32.
    """
    dev = device_rules.resolve(device)
    check_supported(cfg)
    device_rules.pin_fp32()
    for name, t in (("state.xyz", state.xyz), ("camera.world_view", camera.world_view),
                    ("bg", bg)):
        device_rules.check_on(name, t, dev)
    means3d, scales, rotations, opacity, shs, dx = deformed_attributes(
        state, net, camera.time, iteration, cfg, latent)
    out = render_gaussians(
        means3d, scales, rotations, opacity, shs,
        viewmatrix=camera.world_view, projmatrix=camera.full_proj,
        campos=camera.camera_center, bg=bg, width=width, height=height,
        tan_fovx=tan_fovx, tan_fovy=tan_fovy, sh_degree=active_sh_degree,
        scale_modifier=scale_modifier, alive=state.alive,
        means2d_offset_ndc=means2d_offset_ndc, cfg=cfg.raster)
    return out, dx
