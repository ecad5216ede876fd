"""Training-side entry points: the train step, the chunked train loop,
densify/prune, the opacity reset, capacity growth and the eval renders.

Port of ``gs_deformable_tpu/training.py`` (``TrainState``,
``init_train_state``, ``learning_rates``, ``make_train_step``,
``make_chunk_step``, ``make_densify_step``, ``make_opacity_reset``,
``make_eval_render``, ``make_eval_render_batch``, ``run_eval_batches``,
``eval_sweep``, ``grow_capacity``).  One step runs deformation MLP -> activations ->
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import device as device_rules
from . import tracing
from .config import Config, check_supported, layout_unit
from .models.deform import (
    DeformMLP,
    OffsetNet,
    SE3Net,
    init_latent_params,
    init_offset_params,
    init_se3_params,
    make_latent_heads,
)
from .models.gaussians import (
    PARAM_GROUPS,
    AdamState,
    GaussianState,
    adam_init,
    adam_step,
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
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
    # OffsetNet, or SE3Net under deform_mode="se3"; None for "none".  Its
    # Adam group is "offset_model" either way, as in the JAX state.
    net: Optional[DeformMLP]
    adam: AdamState
    # Draws the split children's offsets (make_densify_step); on the
    # gaussians' device.  The JAX state's PRNG key has no counterpart.
    generator: torch.Generator
    # The four latent heads (models.deform.make_latent_heads): no gradient,
    # no Adam group; the opacity gate reads "opacity_mask".
    latent: Optional[Dict[str, DeformMLP]] = None


def make_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _params(state: GaussianState, net: Optional[DeformMLP]) -> Dict:
    params = dict(state.params())
    if net is not None:
        params["offset_model"] = net.param_tree()
    return params


def init_nets(cfg: Config, seed: int = 0, device="cuda"):
    """(net, latent heads) for ``cfg.model.deform_mode`` from numpy inits
    seeded by ``seed``: the ``SE3Net`` under "se3", the ``OffsetNet`` under
    "offset", None under "none"; the four latent heads always
    (training.py:54-62 of the JAX package, which draws them from its key)."""
    dev = device_rules.resolve(device)
    mode = cfg.model.deform_mode
    net = None
    if mode == "se3":
        net = SE3Net(init_se3_params(seed, cfg.deform), cfg.deform, device=dev)
    elif mode == "offset":
        net = OffsetNet(init_offset_params(seed, cfg.deform), cfg.deform, device=dev)
    return net, make_latent_heads(init_latent_params(seed + 1, cfg.deform), cfg.deform,
                                  device=dev)


def init_train_state(state: GaussianState, net: Optional[DeformMLP], seed: int = 0,
                     latent: Optional[Dict[str, DeformMLP]] = None) -> TrainState:
    """Zero Adam moments for the six groups and, with a net, ``"offset_model"``;
    a generator seeded with ``seed`` on the state's device.  ``latent``
    takes no moments.

    The JAX version draws the nets from ``jax.random``; here they come from
    ``init_nets`` (or ``models.deform``'s numpy inits) or from ``convert``.
    """
    return TrainState(state, net, adam_init(_params(state, net)),
                      make_generator(seed, state.xyz.device), latent)


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


def _trainable_inputs(ts: TrainState, device):
    """(the six groups as leaves that take a gradient, the net's parameters,
    ``screen_zero``: the zero NDC tap, whose gradient is dL/d ndc mean2D)."""
    g = ts.gaussians
    leaves = {k: v.detach().requires_grad_(True) for k, v in g.params().items()}
    net_params = [] if ts.net is None else tree_leaves(ts.net.param_tree())
    return leaves, net_params, torch.zeros((g.capacity, 2), dtype=torch.float32,
                                           device=device, requires_grad=True)


def _masked_offset_norms(dx: torch.Tensor, alive_f: torch.Tensor) -> torch.Tensor:
    """|dx| a row times ``alive_f``.  dx is 0 in dead slots and in warmup, where
    sqrt's derivative is infinite: the double where keeps 0 * inf out of the MLP."""
    sq = (dx * dx).sum(dim=-1)
    nz = sq > 0
    return torch.sqrt(torch.where(nz, sq, 1.0)) * nz.to(torch.float32) * alive_f


def _combined_loss(cfg: Config, ll1, offset_norm, ssim_val, ssim_one=1.0):
    """The module docstring's loss; the mesh's bands pass their shares, and
    ``ssim_one = 1 / n_model``."""
    o = cfg.opt
    return ((1.0 - o.lambda_dssim) * (ll1 + o.lambda_offset_norm * offset_norm)
            + o.lambda_dssim * (ssim_one - ssim_val))


def _gradients(loss, leaves, net_params, screen_zero):
    """d loss / d ``_trainable_inputs`` (zeros where unused): the groups', the
    net's and the NDC tap's."""
    inputs = [*leaves.values(), *net_params, screen_zero]
    with tracing.span("gs.backward"):
        grads = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
    return grads[:len(leaves)], grads[len(leaves):-1], grads[-1]


def _apply_update(ts: TrainState, gstate: GaussianState, g_gauss, g_net, iteration: int,
                  cfg: Config, spatial_lr_scale: float, device) -> TrainState:
    """Adam on every group of ``gstate`` (the step's state with its new
    statistics) and of the net, which is written back in place."""
    o = cfg.opt
    params = _params(gstate, ts.net)
    grad_tree = dict(zip(PARAM_GROUPS, g_gauss))
    net_leaves = tree_leaves(params.get("offset_model", []))
    if net_leaves:
        by_leaf = dict(zip(map(id, net_leaves), g_net))
        grad_tree["offset_model"] = tree_map(lambda p: by_leaf[id(p)], params["offset_model"])
    lrs = learning_rates(iteration, cfg, spatial_lr_scale, device=device)
    new_params, new_adam = adam_step(params, grad_tree, ts.adam, lrs,
                                     b1=o.adam_b1, b2=o.adam_b2, eps=o.adam_eps)
    with torch.no_grad():
        for p, v in zip(net_leaves, tree_leaves(new_params.pop("offset_model", []))):
            p.copy_(v)
    return dataclasses.replace(ts, gaussians=gstate.with_params(new_params), adam=new_adam)


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
        with tracing.span("gs.step"):
            device_rules.check_on("gt_image", gt_image, dev)
            g0 = ts.gaussians
            alive_f = g0.alive.to(torch.float32)
            leaves, net_params, screen_zero = _trainable_inputs(ts, dev)
            out, dx = render(g0.with_params(leaves), ts.net, cam, iteration=iteration, bg=bg,
                             width=width, height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                             active_sh_degree=active_sh_degree, cfg=cfg,
                             means2d_offset_ndc=screen_zero, latent=ts.latent, device=dev)
            img = out.image
            ll1 = l1_loss(img, gt_image)
            norms = _masked_offset_norms(dx, alive_f)
            offset_norm = norms.sum() / torch.clamp(alive_f.sum(), min=1.0)
            ssim_val = ssim(img, gt_image)
            loss = _combined_loss(cfg, ll1, offset_norm, ssim_val)
            g_gauss, g_net, g_screen = _gradients(loss, leaves, net_params, screen_zero)

            gstate = add_densification_stats(g0, g_screen,
                                              out.visibility & (iteration < o.densify_until_iter),
                                              out.radii)
            gstate = dataclasses.replace(gstate, last_offset_norm=norms.detach())
            ts = _apply_update(ts, gstate, g_gauss, g_net, iteration, cfg, spatial_lr_scale, dev)

            with torch.no_grad():
                metrics = {
                    "loss": loss.detach(),
                    "ll1": ll1.detach(),
                    "ssim": ssim_val.detach(),
                    "psnr": psnr(img[None], gt_image[None]).mean(),
                    "offset_norm": offset_norm.detach(),
                    "required_instances": out.required_instances,
                    "required_aligned": out.required_aligned,
                    "n_alive": ts.gaussians.num_alive,
                }
            return ts, metrics

    return step


def make_chunk_step(cfg: Config, *, width: int, height: int, tan_fovx: float,
                    tan_fovy: float, active_sh_degree: int, spatial_lr_scale: float,
                    chunk_max: int = 10, device="cuda"):
    """Up to ``chunk_max`` train steps in one call (training.py:217-298 of the
    JAX package): ``run(ts, cams, gts, bg, it0, n, losses=None) -> (ts, metrics)``.

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
    ``ts`` is updated in place as ``make_train_step`` does.  A list given as
    ``losses`` gets each step's loss appended, as a 0-d tensor on ``device``.
    """
    dev = device_rules.resolve(device)
    step = make_train_step(cfg, width=width, height=height, tan_fovx=tan_fovx,
                           tan_fovy=tan_fovy, active_sh_degree=active_sh_degree,
                           spatial_lr_scale=spatial_lr_scale, device=dev)
    r = cfg.raster
    num_tiles = ((width + r.tile_x - 1) // r.tile_x) * ((height + r.tile_y - 1) // r.tile_y)
    kp = aligned_capacity(r.instance_capacity, num_tiles, layout_unit(r), r.aligned_slack)
    return chunk_loop(step, kp=kp, instance_capacity=r.instance_capacity, chunk_max=chunk_max,
                      device=dev)


def chunk_loop(step: Callable, *, kp: int, instance_capacity: int, chunk_max: int, device):
    """The host loop of ``make_chunk_step`` (and of the mesh's
    ``make_sharded_chunk_step``) over ``step(ts, cam, gt, bg, iteration)``:
    a step overflows when it needs more than ``instance_capacity`` instances
    or more than ``kp`` aligned rows."""
    dev = device_rules.resolve(device)
    last_keys = ("loss", "ll1", "ssim", "psnr", "offset_norm", "n_alive")

    def run(ts: TrainState, cams: CameraArrays, gts: torch.Tensor, bg: torch.Tensor,
            it0: int, n: int, losses: Optional[list] = None):
        with tracing.span("gs.chunk"):
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
                over = ((m["required_instances"] > instance_capacity)
                        | (m["required_aligned"] > kp))
                if losses is not None:
                    losses.append(m["loss"])
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
    """No-grad render for eval sweeps:
    ``run(state, net, cam, bg, iteration, latent=None) -> image``.

    ``device`` defaults to ``"cuda"`` and raises when no GPU exists;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels.  The
    returned function turns TF32 off (see ``renderer.render``).
    """
    dev = device_rules.resolve(device)
    check_supported(cfg)

    def run(state: GaussianState, net: Optional[DeformMLP], cam: CameraArrays,
            bg: torch.Tensor, iteration: int,
            latent: Optional[Dict[str, DeformMLP]] = None) -> torch.Tensor:
        with tracing.span("gs.frame"), torch.no_grad():
            out, _ = render(state, net, cam, iteration=iteration, bg=bg, width=width,
                            height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                            active_sh_degree=active_sh_degree, cfg=cfg, latent=latent,
                            device=dev)
        return out.image

    return run


def make_densify_step(cfg: Config, extent: float, use_screen_prune: bool, device="cuda"):
    """``run(ts, grad_threshold, min_opacity, normals=None) -> (ts, info)``:
    ``models.gaussians.densify_and_prune`` on the six groups' Adam moments
    (train.py:643-645 of the JAX package), ``info`` the ``DensifyInfo``
    counts as a dict of 0-d tensors.

    The split children's (P, 2, 3) standard normals are drawn from
    ``ts.generator`` unless ``normals`` is given (the tests pass the JAX
    step's own draw).  ``cfg.opt.densify_offset_gate > 0`` also limits
    clone and split to rows whose latest offset norm reaches it.  A
    ``TrainState`` holds no capacity-sized buffer of the step, so the same
    function serves a state after ``grow_capacity``.
    """
    dev = device_rules.resolve(device)

    def run(ts: TrainState, grad_threshold, min_opacity,
            normals: Optional[torch.Tensor] = None):
        g = ts.gaussians
        device_rules.check_on("ts.gaussians.xyz", g.xyz, dev)
        if normals is None:
            normals = torch.randn((g.capacity, 2, 3), generator=ts.generator, device=dev)
        offset_mask = None
        if cfg.opt.densify_offset_gate > 0.0:
            offset_mask = g.last_offset_norm >= cfg.opt.densify_offset_gate
        gstate, mu, nu, info = densify_and_prune(
            g, {k: ts.adam.mu[k] for k in PARAM_GROUPS},
            {k: ts.adam.nu[k] for k in PARAM_GROUPS}, normals,
            grad_threshold=grad_threshold, min_opacity=min_opacity, extent=extent,
            percent_dense=cfg.opt.percent_dense, use_screen_prune=use_screen_prune,
            offset_mask=offset_mask)
        adam = dataclasses.replace(ts.adam, mu={**ts.adam.mu, **mu}, nu={**ts.adam.nu, **nu})
        return dataclasses.replace(ts, gaussians=gstate, adam=adam), info._asdict()

    return run


def make_opacity_reset(cfg: Config):
    """``run(ts) -> ts`` with ``models.gaussians.reset_opacity`` applied."""

    def run(ts: TrainState) -> TrainState:
        gstate, mu, nu = reset_opacity(ts.gaussians, ts.adam.mu, ts.adam.nu)
        return dataclasses.replace(ts, gaussians=gstate,
                                   adam=dataclasses.replace(ts.adam, mu=mu, nu=nu))

    return run


def make_eval_render_batch(cfg: Config, *, width: int, height: int, tan_fovx: float,
                           tan_fovy: float, active_sh_degree: int, device="cuda"):
    """No-grad eval of a list of cameras: ``run(ts, cams, gts, bg, iteration)
    -> (images, l1, psnr, ssim)``, each with a leading batch axis.

    ``cams`` is a sequence of B ``CameraArrays`` and ``gts`` is
    (B, 3, H, W); images and targets are clipped to [0, 1] before the
    metrics.  Nothing waits for the card.
    """
    render_one = make_eval_render(cfg, width=width, height=height, tan_fovx=tan_fovx,
                                  tan_fovy=tan_fovy, active_sh_degree=active_sh_degree,
                                  device=device)

    def run(ts: TrainState, cams: Sequence[CameraArrays], gts: torch.Tensor,
            bg: torch.Tensor, iteration: int):
        out = []
        with torch.no_grad():
            for cam, gt in zip(cams, gts, strict=True):
                img = torch.clamp(render_one(ts.gaussians, ts.net, cam, bg, iteration,
                                             ts.latent), 0.0, 1.0)
                gt = torch.clamp(gt, 0.0, 1.0)
                out.append((img, (img - gt).abs().mean(), psnr(img[None], gt[None]).mean(),
                            ssim(img, gt)))
        return tuple(torch.stack(x) for x in zip(*out))

    return run


def run_eval_batches(eval_batch_fn, ts: TrainState, cam_arr_list: Sequence[CameraArrays],
                     gt_list: Sequence, bg: torch.Tensor, iteration: int,
                     batch: int) -> List[Tuple[np.ndarray, float, float, float]]:
    """Per-view ``(image, l1, psnr, ssim)`` in input order, ``batch`` views a
    call of ``eval_batch_fn`` and one wait for the card a batch.

    ``gt_list`` holds (3, H, W) tensors on the state's device or numpy
    arrays.  The last batch is short: the JAX version pads it by repeating
    its last view, because its compiled batch has one size.
    """
    dev = ts.gaussians.xyz.device
    out = []
    for s in range(0, len(cam_arr_list), batch):
        gts = torch.stack([torch.as_tensor(g, dtype=torch.float32, device=dev)
                           for g in gt_list[s:s + batch]])
        imgs, l1, ps, ss = eval_batch_fn(ts, cam_arr_list[s:s + batch], gts, bg, iteration)
        imgs = imgs.cpu().numpy()
        for j, (a, b, c) in enumerate(zip(l1.tolist(), ps.tolist(), ss.tolist())):
            out.append((imgs[j], a, b, c))
    return out


def eval_sweep(make_batch_fn: Callable, ts: TrainState, cams: Sequence, cam_to_arrays: Callable,
               cam_to_gt: Callable, bg: torch.Tensor, iteration: int,
               batch: int = 10) -> List[Tuple[np.ndarray, float, float, float]]:
    """Batched eval over cameras of mixed sizes: views grouped by (width,
    height, fovx, fovy), ``make_batch_fn(cam)`` giving each group's
    ``make_eval_render_batch`` function, ``cam_to_arrays`` / ``cam_to_gt``
    mapping a ``data.cameras.Camera`` to its ``CameraArrays`` and (3, H, W)
    ground truth.  Returns per-view ``(image, l1, psnr, ssim)`` in the
    order of ``cams``."""
    groups: Dict[Tuple, list] = {}
    for i, c in enumerate(cams):
        groups.setdefault((c.width, c.height, round(c.fovx, 6), round(c.fovy, 6)), []).append(i)
    results = [None] * len(cams)
    for idxs in groups.values():
        res = run_eval_batches(make_batch_fn(cams[idxs[0]]), ts,
                               [cam_to_arrays(cams[i]) for i in idxs],
                               [cam_to_gt(cams[i]) for i in idxs], bg, iteration, batch)
        for i, r in zip(idxs, res):
            results[i] = r
    return results


@torch.no_grad()
def grow_capacity(ts: TrainState, new_capacity: int) -> TrainState:
    """Every per-gaussian tensor and the six groups' moments padded to
    ``new_capacity`` rows: dead, identity rotations, zeros elsewhere.  The
    nets (latent heads included), the net's moments, the step count and the
    generator carry over."""
    old = ts.gaussians.capacity
    if new_capacity <= old:
        raise ValueError(f"new capacity {new_capacity} must exceed {old}")

    def pad(x):
        return torch.cat([x, x.new_zeros((new_capacity - old,) + x.shape[1:])])

    ts = _rows_map(ts, pad)
    ts.gaussians.rotation[old:, 0] = 1.0
    return ts


def _rows_map(ts: TrainState, fn) -> TrainState:
    """``fn`` on every per-gaussian tensor: the state's fields and the six
    groups' Adam moments."""
    g = ts.gaussians

    def mom(tree):
        return {k: fn(v) if k in PARAM_GROUPS else v for k, v in tree.items()}

    gauss = GaussianState(**{f.name: fn(getattr(g, f.name)) for f in dataclasses.fields(g)})
    adam = dataclasses.replace(ts.adam, mu=mom(ts.adam.mu), nu=mom(ts.adam.nu))
    return dataclasses.replace(ts, gaussians=gauss, adam=adam)
