"""Training-side entry points: the train step, the chunked train loop and
the eval render.

Port of ``gs_deformable_tpu/training.py`` (``TrainState``,
``init_train_state``, ``learning_rates``, ``make_train_step``,
``make_chunk_step``, ``make_eval_render``).  One step runs deformation MLP -> activations ->
EWA preprocess -> SH -> tiled rasterize (CUDA composite forward) ->
L1 + SSIM + offset-norm loss -> backward (CUDA composite backward, the
gather's per-gaussian segment sum, autograd for the rest) ->
densification statistics -> per-group Adam.

Loss (reference train.py:323-332, 529):
  Ll1' = L1(img, gt) + lambda_offset_norm * mean(|dx|)
  loss = (1 - lambda_dssim) * Ll1' + lambda_dssim * (1 - SSIM)
with the offset-norm mean over alive gaussians.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from . import device as device_rules
from .config import Config, check_supported, layout_unit
from .models.deform import OffsetNet
from .models.gaussians import (
    AdamState,
    GaussianState,
    adam_init,
    adam_step,
    add_densification_stats,
    tree_leaves,
    tree_map,
)
from .ops.binning import aligned_capacity
from .renderer import CameraArrays, render
from .utils.general import expon_lr, psnr
from .utils.losses import l1_loss, ssim


@dataclasses.dataclass
class TrainState:
    gaussians: GaussianState
    net: Optional[OffsetNet]  # None for deform_mode="none"
    adam: AdamState


def _params(state: GaussianState, net: Optional[OffsetNet]) -> Dict:
    params = dict(state.params())
    if net is not None:
        params["offset_model"] = net.param_tree()
    return params


def init_train_state(state: GaussianState, net: Optional[OffsetNet]) -> TrainState:
    """Zero Adam moments for the six groups and, with a net, ``"offset_model"``.

    The JAX version draws the net from ``jax.random``; here it comes from
    ``models.deform.init_offset_params(seed)`` or from ``convert``.
    """
    return TrainState(state, net, adam_init(_params(state, net)))


def learning_rates(iteration, cfg: Config, spatial_lr_scale: float,
                   device="cpu") -> Dict[str, torch.Tensor]:
    """Per-group learning rates as fp32 scalars: xyz and offset_model decay
    exponentially, the rest are constants (gaussian_model.py:834-886)."""
    o = cfg.opt

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    return {
        "xyz": expon_lr(iteration, o.position_lr_init * spatial_lr_scale,
                        o.position_lr_final * spatial_lr_scale,
                        lr_delay_mult=o.position_lr_delay_mult, lr_delay_steps=0,
                        max_steps=o.position_lr_max_steps, device=device),
        "offset_model": expon_lr(iteration, o.offset_lr_init, o.offset_lr_final,
                                 max_steps=o.position_lr_max_steps, device=device),
        "f_dc": const(o.feature_lr),
        "f_rest": const(o.feature_lr / 20.0),
        "opacity": const(o.opacity_lr),
        "scaling": const(o.scaling_lr),
        "rotation": const(o.rotation_lr),
    }


def make_train_step(cfg: Config, *, width: int, height: int, tan_fovx: float,
                    tan_fovy: float, active_sh_degree: int, spatial_lr_scale: float,
                    device="cuda"):
    """Single-camera train step: ``step(ts, cam, gt_image, bg, iteration) -> (ts, metrics)``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU exists;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.  Every
    tensor of ``ts``, ``cam``, ``gt_image`` (3, H, W) and ``bg`` (3,) must lie
    on it; ``iteration`` is a Python int.  TF32 is turned off.

    The step updates ``ts`` in place where the JAX version donates it: the
    net's parameters are overwritten with their Adam update, so the
    ``ts.net`` passed in is the returned state's net.  The metrics are the
    JAX step's keys, as 0-d tensors on ``device``.
    """
    dev = device_rules.resolve(device)
    check_supported(cfg)
    o = cfg.opt

    def step(ts: TrainState, cam: CameraArrays, gt_image: torch.Tensor, bg: torch.Tensor,
             iteration: int):
        device_rules.check_on("gt_image", gt_image, dev)
        g0 = ts.gaussians
        alive_f = g0.alive.to(torch.float32)
        leaves = {k: v.detach().requires_grad_(True) for k, v in g0.params().items()}
        net_params = [] if ts.net is None else tree_leaves(ts.net.param_tree())
        screen_zero = torch.zeros((g0.capacity, 2), dtype=torch.float32, device=dev,
                                  requires_grad=True)

        out, dx = render(g0.with_params(leaves), ts.net, cam, iteration=iteration, bg=bg,
                         width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                         active_sh_degree=active_sh_degree, cfg=cfg,
                         means2d_offset_ndc=screen_zero, device=dev)
        img = out.image
        ll1 = l1_loss(img, gt_image)
        # dx is exactly 0 in dead slots and during warmup, where sqrt has an
        # infinite derivative: the double where keeps 0 * inf out of the MLP.
        sq = (dx * dx).sum(dim=-1)
        nz = sq > 0
        norms = torch.sqrt(torch.where(nz, sq, 1.0)) * nz.to(torch.float32)
        offset_norm = (norms * alive_f).sum() / torch.clamp(alive_f.sum(), min=1.0)
        ssim_val = ssim(img, gt_image)
        loss = ((1.0 - o.lambda_dssim) * (ll1 + o.lambda_offset_norm * offset_norm)
                + o.lambda_dssim * (1.0 - ssim_val))

        inputs = [*leaves.values(), *net_params, screen_zero]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        g_screen = grads[-1]
        grad_tree = dict(zip(leaves, grads[:len(leaves)]))
        if ts.net is not None:
            it = iter(grads[len(leaves):-1])
            grad_tree["offset_model"] = tree_map(lambda _: next(it), ts.net.param_tree())

        gstate = add_densification_stats(g0, g_screen,
                                          out.visibility & (iteration < o.densify_until_iter),
                                          out.radii)
        gstate = dataclasses.replace(gstate, last_offset_norm=(norms * alive_f).detach())

        lrs = learning_rates(iteration, cfg, spatial_lr_scale, device=dev)
        new_params, new_adam = adam_step(_params(gstate, ts.net), grad_tree, ts.adam, lrs,
                                         b1=o.adam_b1, b2=o.adam_b2, eps=o.adam_eps)
        new_net = new_params.pop("offset_model", None)
        if ts.net is not None:
            with torch.no_grad():
                for p, v in zip(net_params, tree_leaves(new_net)):
                    p.copy_(v)
        gstate = gstate.with_params(new_params)

        with torch.no_grad():
            metrics = {
                "loss": loss.detach(),
                "ll1": ll1.detach(),
                "ssim": ssim_val.detach(),
                "psnr": psnr(img[None], gt_image[None]).mean(),
                "offset_norm": offset_norm.detach(),
                "required_instances": out.required_instances,
                "required_aligned": out.required_aligned,
                "n_alive": gstate.num_alive,
            }
        return TrainState(gstate, ts.net, new_adam), metrics

    return step


def make_chunk_step(cfg: Config, *, width: int, height: int, tan_fovx: float,
                    tan_fovy: float, active_sh_degree: int, spatial_lr_scale: float,
                    chunk_max: int = 10, device="cuda"):
    """Up to ``chunk_max`` train steps in one call (training.py:217-298 of the
    JAX package): ``run(ts, cams, gts, bg, it0, n) -> (ts, metrics)``.

    ``cams`` holds each ``CameraArrays`` field stacked on a leading
    ``chunk_max`` axis, ``gts`` is ``(chunk_max, 3, H, W)``; step i of the
    ``n`` (a Python int, ``0 <= n <= chunk_max``) takes camera and target i
    at iteration ``it0 + i``.  The metrics are the JAX keys: the last step's
    losses, ``psnr``, ``offset_norm`` and ``n_alive``; the largest
    ``required_instances`` and ``required_aligned`` of the chunk; and
    ``overflow_frames``, the steps that needed more instances than
    ``instance_capacity`` or more aligned rows than Kp.  They stay 0-d
    tensors on ``device``: nothing in the loop waits for the card.

    Kp is sized from ``config.layout_unit``, the alignment the binning uses.
    (The JAX function sizes it from ``cfg.raster.chunk`` even under
    ``composite_mode="packed"``, whose layout is aligned to ``sub_chunk``.)
    ``ts`` is updated in place as ``make_train_step`` does.
    """
    dev = device_rules.resolve(device)
    step = make_train_step(cfg, width=width, height=height, tan_fovx=tan_fovx,
                           tan_fovy=tan_fovy, active_sh_degree=active_sh_degree,
                           spatial_lr_scale=spatial_lr_scale, device=dev)
    r = cfg.raster
    num_tiles = ((width + r.tile_x - 1) // r.tile_x) * ((height + r.tile_y - 1) // r.tile_y)
    kp = aligned_capacity(r.instance_capacity, num_tiles, layout_unit(r), r.aligned_slack)
    last_keys = ("loss", "ll1", "ssim", "psnr", "offset_norm", "n_alive")

    def run(ts: TrainState, cams: CameraArrays, gts: torch.Tensor, bg: torch.Tensor,
            it0: int, n: int):
        if not 0 <= n <= chunk_max:
            raise ValueError(f"n must lie in [0, {chunk_max}], got {n}")
        if gts.shape[0] != chunk_max or cams.time.shape[0] != chunk_max:
            raise ValueError(f"cams and gts must be stacked on a leading axis of {chunk_max}")
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = {k: torch.zeros((), dtype=torch.float32, device=dev) for k in last_keys[:-1]}
        metrics.update(n_alive=zero_i, required_instances=zero_i, required_aligned=zero_i,
                       overflow_frames=zero_i)
        for i in range(n):
            cam = CameraArrays(*(x[i] for x in cams))
            ts, m = step(ts, cam, gts[i], bg, it0 + i)
            over = (m["required_instances"] > r.instance_capacity) | (m["required_aligned"] > kp)
            metrics.update({k: m[k] for k in last_keys})
            metrics["required_instances"] = torch.maximum(metrics["required_instances"],
                                                          m["required_instances"])
            metrics["required_aligned"] = torch.maximum(metrics["required_aligned"],
                                                        m["required_aligned"])
            metrics["overflow_frames"] = metrics["overflow_frames"] + over.to(torch.int32)
        return ts, metrics

    return run


def make_eval_render(cfg: Config, *, width: int, height: int, tan_fovx: float,
                     tan_fovy: float, active_sh_degree: int, device="cuda"):
    """No-grad render for eval sweeps: ``run(state, net, cam, bg, iteration) -> image``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU exists;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.  The
    returned function turns TF32 off (see ``renderer.render``).
    """
    dev = device_rules.resolve(device)
    check_supported(cfg)

    def run(state: GaussianState, net: Optional[OffsetNet], cam: CameraArrays,
            bg: torch.Tensor, iteration: int) -> torch.Tensor:
        with torch.no_grad():
            out, _ = render(state, net, cam, iteration=iteration, bg=bg, width=width,
                            height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                            active_sh_degree=active_sh_degree, cfg=cfg, device=dev)
        return out.image

    return run
