"""Training over a ('data', 'model') mesh of processes, one process per device.

Port of ``gs_deformable_tpu/parallel/sharding.py``.  JAX runs one program
over the mesh (``shard_map``); here each rank is a process that holds its
own slice and calls ``torch.distributed`` collectives, in the same order on
every rank.  Rank ``r`` sits at data row ``r // n_model`` and model column
``r % n_model``, as JAX's ``devices.reshape(n_data, n_model)``.

- **data axis**: one camera per data row; parameter gradients are averaged
  over the rows (``n_data`` reference iterations sharing one update).
- **model axis**: each rank holds a contiguous ``capacity / n_model`` slice
  of every per-gaussian tensor, its Adam moments and its densification
  statistics; the nets, the latent heads and the Adam step count are
  replicated.  The per-gaussian work (deformation, activations,
  ``ops.rasterize.screen_space``) runs on the slice; its records (14
  floats a gaussian) are all-gathered over the model group; each rank bins
  and composites only its band of tile rows (``ops.rasterize.
  composite_tiles``, so every composite, fill and cull variant comes
  along); the bands are all-gathered into the image; the loss is split
  exactly by band rows.  The gathers' backward sums every rank's gradient
  for each rank's own rows, so each slice receives the gradient of the total
  loss and only the replicated net needs a sum over the model group.
- The tile grid is padded with empty rows to a multiple of ``n_model``.
- The inputs, offset norms, loss, gradients and Adam update are those of
  ``training.make_train_step``; this module adds the gathers and reductions.

Collectives go through ``_all_reduce`` / ``_all_gather``, which hand the
tensors to ``torch.distributed`` as they are on every backend: NCCL, and
gloo (the CPU, or several ranks sharing one card, which NCCL refuses), whose
collectives take CUDA tensors and copy them through host memory themselves,
so the compute stays on the card.  The gathers' backward is an
``all_reduce`` of the whole gradient followed by taking the local rows,
which every backend takes (``n_model`` times the bytes of a reduce-scatter).
A group of one rank makes no call.  No collective depends on the rank or on
the data, so every rank issues the same sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_rules
from ..config import Config, check_supported, layout_unit
from ..models.gaussians import _densification_increments
from ..ops.binning import aligned_capacity
from ..ops.projection import ndc2pix
from ..ops.rasterize import composite_tiles, screen_space, tiles_to_image
from ..renderer import CameraArrays, deformed_attributes
from ..training import (
    TrainState,
    _apply_update,
    _combined_loss,
    _gradients,
    _masked_offset_norms,
    _rows_map,
    _trainable_inputs,
    chunk_loop,
    make_densify_step,
    make_generator,
    make_opacity_reset,
)
from ..utils.general import psnr
from ..utils.losses import ssim_map

@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh and the groups it talks over.

    ``model_group`` / ``data_group`` are None where that axis has one rank
    (no collective is made over it); ``world_group`` is None for one rank.
    """

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    device: torch.device
    model_group: Optional[object] = None
    data_group: Optional[object] = None
    world_group: Optional[object] = None

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.model_index


def make_mesh(n_data: int, n_model: int, device="cuda") -> Mesh:
    """The mesh of an initialised process group (``torch.distributed``),
    whose world size must be ``n_data * n_model``.  With no process group,
    only a 1x1 mesh is made.  Every rank must call it (it makes the groups)."""
    dev = device_rules.resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data < 1 or n_model < 1 or world != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} mesh needs n_data * n_model = "
                         f"{n_data * n_model} ranks; the world size is {world}")
    if world == 1:
        return Mesh(1, 1, 0, 0, dev)
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    model_group = data_group = None
    if n_model > 1:
        for row in range(n_data):
            g = dist.new_group([row * n_model + k for k in range(n_model)])
            if row == d:
                model_group = g
    if n_data > 1:
        for col in range(n_model):
            g = dist.new_group([k * n_model + col for k in range(n_data)])
            if col == m:
                data_group = g
    return Mesh(n_data, n_model, d, m, dev, model_group, data_group, dist.group.WORLD)


# -- collectives ---------------------------------------------------------------


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``x`` over ``group`` (``x`` itself may be overwritten);
    ``x`` unchanged when ``group`` is None."""
    if group is None:
        return x
    y = x.contiguous()
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated on dim 0, in group order."""
    if group is None:
        return x
    src = x.detach().contiguous()
    if src.dtype == torch.bool:  # gathered as bytes
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    """All-gather over the model group; the backward hands each rank the sum
    of every rank's gradient for its own rows (JAX's ``all_gather`` VJP,
    a ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, group, index):
        ctx.group, ctx.index, ctx.rows = group, index, x.shape[0]
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad.contiguous().clone(), ctx.group)
        return total[ctx.index * ctx.rows:(ctx.index + 1) * ctx.rows], None, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-gather of ``x`` over the mesh's model group."""
    if mesh.model_group is None:
        return x
    return _GatherRows.apply(x, mesh.model_group, mesh.model_index)


def _reduce_flat(tensors, group) -> list:
    """Each tensor summed over ``group`` by one collective on their concatenation."""
    flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [p.view_as(t) for p, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                         tensors)]


# -- state layout --------------------------------------------------------------


def interleave_perm(capacity: int, n_model: int) -> np.ndarray:
    """Round-robin row relabelling: new row (shard s, slot k) <- old row
    k * n_model + s (sharding.py:94-102 of the JAX package), so the alive rows
    (contiguous after init) spread evenly and every shard's densify free
    pool stays balanced.  Only equal-(tile, depth) sort ties can reassociate."""
    return np.arange(capacity).reshape(-1, n_model).T.reshape(-1)


def permute_gaussian_rows(ts: TrainState, perm: np.ndarray) -> TrainState:
    """Every per-gaussian tensor (fields and moments) with its rows in ``perm``
    order; the nets, latent heads, step count and generator untouched."""
    idx = torch.as_tensor(perm, dtype=torch.int64, device=ts.gaussians.xyz.device)
    return _rows_map(ts, lambda x: x[idx])


def shard_train_state(ts: TrainState, mesh: Mesh) -> TrainState:
    """This rank's model slice of a full ``TrainState``: rows
    ``[m * capacity / n_model, (m + 1) * capacity / n_model)`` of every
    per-gaussian tensor after the interleave (as the JAX trainer always
    shards), copied so the full tensors can be freed.  The nets, latent heads
    and Adam step stay as given (replicated).

    With ``n_model > 1`` the rank's generator is a new one seeded by a draw
    from ``ts.generator`` plus the model index, the counterpart of JAX's
    ``fold_in(key, model index)`` (sharding.py:545-546): data replicas draw
    the same split offsets, the model shards different ones."""
    n = mesh.n_model
    cap = ts.gaussians.capacity
    if cap % n:
        raise ValueError(f"capacity {cap} is not a multiple of n_model {n}")
    if n == 1:
        return ts
    ts = permute_gaussian_rows(ts, interleave_perm(cap, n))
    lo, hi = mesh.model_index * (cap // n), (mesh.model_index + 1) * (cap // n)
    ts = _rows_map(ts, lambda x: x[lo:hi].clone())
    dev = ts.gaussians.xyz.device
    base = int(torch.randint(0, 2**62, (), generator=ts.generator, device=dev))
    return dataclasses.replace(ts, generator=make_generator(base + mesh.model_index, dev))


def gather_train_state(ts: TrainState, mesh: Mesh) -> TrainState:
    """The full state from every rank's slice, in JAX's global row order (the
    slices concatenated in model order, the interleave kept).  The nets,
    latent heads, step count and this rank's generator are carried over.
    Every rank of the model group must call it."""
    if mesh.model_group is None:
        return ts
    return _rows_map(ts, lambda x: _all_gather(x, mesh.model_group))


# -- the step ------------------------------------------------------------------


def make_sharded_train_step(cfg: Config, mesh: Mesh, *, width: int, height: int,
                            tan_fovx: float, tan_fovy: float, active_sh_degree: int,
                            spatial_lr_scale: float):
    """``step(ts, cam, gt, bg, iteration) -> (ts, metrics)`` on this rank.

    ``ts`` is the rank's slice (``shard_train_state``); ``cam`` and ``gt``
    (3, H, W) are this rank's data row (its camera); ``bg`` (3,);
    ``iteration`` a Python int, the same on every rank.  Every rank of the
    mesh must call it together.  The metrics are the JAX sharded step's keys
    (loss, ll1 and psnr averaged over the data rows, required instances and
    aligned rows as the largest band's, alive over the model group) plus
    the single-device step's ``ssim`` and ``offset_norm``, all equal on
    every rank.  ``ts`` is updated in place as ``training.make_train_step``
    does (the net's parameters).  The gradients and statistics are JAX's:
    the per-gaussian gradients averaged over the data rows, the net's summed
    over the model group and averaged over the data rows, ``denom`` and
    ``xyz_gradient_accum`` summed over the data rows and ``max_radii2d``
    their maximum.  ``last_offset_norm`` is data row 0's on every rank (JAX
    keeps each row's own, and its replicated output reads row 0's), so data
    replicas stay equal.
    """
    dev = device_rules.resolve(mesh.device)
    check_supported(cfg)
    device_rules.pin_fp32()  # in every rank's process, as renderer.render does
    n_data, n_model, midx = mesh.n_data, mesh.n_model, mesh.model_index
    r, o = cfg.raster, cfg.opt
    grid_x = (width + r.tile_x - 1) // r.tile_x
    grid_y = (height + r.tile_y - 1) // r.tile_y
    band_rows = -(-grid_y // n_model)  # empty rows pad the last band
    band_px = band_rows * r.tile_y
    band_y0 = midx * band_rows
    npx = 3 * height * width
    rows = torch.arange(height, device=dev)
    band_mask = ((rows >= midx * band_px) & (rows < (midx + 1) * band_px)).to(
        torch.float32)[None, :, None]

    def step(ts: TrainState, cam: CameraArrays, gt: torch.Tensor, bg: torch.Tensor,
             iteration: int):
        device_rules.check_on("gt", gt, dev)
        g0 = ts.gaussians
        alive_total = _all_reduce(g0.alive.sum().reshape(1), mesh.model_group)[0]
        leaves, net_params, screen_zero = _trainable_inputs(ts, dev)
        means3d, scales, rotations, opacity, shs, dx = deformed_attributes(
            g0.with_params(leaves), ts.net, cam.time, iteration, cfg, ts.latent)
        ss = screen_space(means3d, scales, rotations, opacity, shs, viewmatrix=cam.world_view,
                          projmatrix=cam.full_proj, campos=cam.camera_center, width=width,
                          height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                          sh_degree=active_sh_degree, alive=g0.alive,
                          means2d_offset_ndc=screen_zero, cfg=r)
        pre = ss.pre
        # The slice's screen-space records, NDC tap included, over the model group.
        rec = torch.cat([ss.means2d_ndc, pre.conics, opacity, ss.colors, pre.depths[:, None],
                         pre.rect.to(torch.float32)], dim=1)
        full = gather_rows(rec, mesh)
        ndc, conics, op_full, col_full = full[:, 0:2], full[:, 2:5], full[:, 5], full[:, 6:9]
        depth_full = full[:, 9]
        rect = full[:, 10:14].detach().to(torch.int32)  # small integers: exact in fp32

        # Band coordinates: splat y and the rects' tile rows move to the band.
        pix = torch.stack([ndc2pix(ndc[:, 0], width),
                           ndc2pix(ndc[:, 1], height) - float(band_y0 * r.tile_y)], dim=-1)
        y0 = torch.clamp(rect[:, 1] - band_y0, 0, band_rows)
        y1 = torch.clamp(rect[:, 3] - band_y0, 0, band_rows)
        rect_band = torch.stack([rect[:, 0], y0, rect[:, 2], y1], dim=-1)
        tiles_band = (rect[:, 2] - rect[:, 0]) * (y1 - y0)
        out_tiles, required, required_aligned = composite_tiles(
            pix, depth_full, conics, op_full, col_full, rect_band, tiles_band,
            grid_x=grid_x, grid_y=band_rows, cfg=r)
        planes = tiles_to_image(gather_rows(out_tiles[:, 0:4], mesh), grid_x=grid_x,
                                width=width, height=height, cfg=r)
        image = planes[0:3] + planes[3][None] * bg[:, None, None]

        # This rank's share of the loss: its band's pixel rows, its slice's
        # offset norms; summed over the model group it is the total loss.
        l1_local = torch.sum(torch.abs(image - gt) * band_mask) / npx
        ssim_local = torch.sum(ssim_map(image, gt) * band_mask) / npx
        norms = _masked_offset_norms(dx, g0.alive.to(torch.float32))
        onorm_local = norms.sum() / torch.clamp(alive_total, min=1).to(torch.float32)
        loss_local = _combined_loss(cfg, l1_local, onorm_local, ssim_local, 1.0 / n_model)
        parts = torch.stack([loss_local, l1_local, ssim_local, onorm_local]).detach()
        g_gauss, g_net, g_screen = _gradients(loss_local, leaves, net_params, screen_zero)

        # psum over 'model' of the net's gradients (the slices' gradients are
        # already the total loss's), with the loss terms riding along.
        *g_net, parts = _reduce_flat([*g_net, parts], mesh.model_group)
        gn, seen, radii = _densification_increments(
            g0, g_screen, (pre.radii > 0) & (iteration < o.densify_until_iter), pre.radii)
        # The offset norms of data row 0 (what JAX's replicated output reads).
        norms0 = norms.detach() * float(mesh.data_index == 0)
        psnr_v = psnr(image.detach()[None], gt[None]).mean().reshape(1)
        # One sum over 'data': the gradients and the metrics (then their mean),
        # the statistics and row 0's norms; the largest radius.
        *means, stats, norms0 = _reduce_flat(
            [*g_gauss, *g_net, parts, psnr_v, torch.cat([gn, seen], dim=1), norms0],
            mesh.data_group)
        if n_data > 1:
            means = [m / n_data for m in means]
        n = len(g_gauss)
        g_gauss, g_net, (parts, psnr_mean) = means[:n], means[n:-2], means[-2:]
        radii = _all_reduce(radii, mesh.data_group, dist.ReduceOp.MAX)
        gstate = dataclasses.replace(
            g0, xyz_gradient_accum=g0.xyz_gradient_accum + stats[:, 0:1],
            denom=g0.denom + stats[:, 1:2], max_radii2d=radii, last_offset_norm=norms0)
        ts = _apply_update(ts, gstate, g_gauss, g_net, iteration, cfg, spatial_lr_scale, dev)

        req = torch.stack([required, required_aligned]).to(torch.int64)
        req = _all_reduce(req, mesh.world_group, dist.ReduceOp.MAX)
        metrics = {
            "loss": parts[0], "ll1": parts[1], "ssim": parts[2], "offset_norm": parts[3],
            "psnr": psnr_mean[0], "required_instances": req[0].to(torch.int32),
            "required_aligned": req[1].to(torch.int32), "n_alive": alive_total,
        }
        return ts, metrics

    return step


def make_sharded_chunk_step(cfg: Config, mesh: Mesh, *, width: int, height: int,
                            tan_fovx: float, tan_fovy: float, active_sh_degree: int,
                            spatial_lr_scale: float, chunk_max: int = 10):
    """Up to ``chunk_max`` sharded steps a call (sharding.py:435-534 of the JAX
    package), a host loop as ``training.make_chunk_step`` is:
    ``run(ts, cams, gts, bg, it0, n, losses=None) -> (ts, metrics)`` with this
    rank's cameras stacked on a leading ``chunk_max`` axis and ``gts``
    (chunk_max, 3, H, W).  Metrics: the last step's, the chunk's largest
    instance demand and ``overflow_frames``, the steps whose band needed more
    instances than ``instance_capacity`` or more aligned rows than the band's
    Kp.  Kp comes from ``config.layout_unit`` over the band's
    ``grid_x * band_rows`` tiles (the JAX function sizes it from
    ``cfg.raster.chunk``)."""
    step = make_sharded_train_step(cfg, mesh, width=width, height=height, tan_fovx=tan_fovx,
                                   tan_fovy=tan_fovy, active_sh_degree=active_sh_degree,
                                   spatial_lr_scale=spatial_lr_scale)
    r = cfg.raster
    kp = aligned_capacity(r.instance_capacity, band_tiles(cfg, mesh.n_model, width, height),
                          layout_unit(r), r.aligned_slack)
    return chunk_loop(step, kp=kp, instance_capacity=r.instance_capacity, chunk_max=chunk_max,
                      device=mesh.device)


def band_tiles(cfg: Config, n_model: int, width: int, height: int) -> int:
    """Tiles of one band of ``n_model``: ``grid_x * band_rows`` (the whole
    grid for one band)."""
    r = cfg.raster
    grid_y = (height + r.tile_y - 1) // r.tile_y
    return ((width + r.tile_x - 1) // r.tile_x) * (-(-grid_y // n_model))


def make_sharded_densify_step(cfg: Config, mesh: Mesh, extent: float, use_screen_prune: bool):
    """``run(ts, grad_threshold, min_opacity, normals=None) -> (ts, info)``:
    ``training.make_densify_step`` on this rank's slice (its own free
    slots; overflow shows in ``n_dropped``), the ``DensifyInfo`` counts
    summed over the model group (sharding.py:537-589).  The split offsets
    come from the rank's generator (see ``shard_train_state``) unless
    ``normals`` (capacity / n_model, 2, 3) is given."""
    local = make_densify_step(cfg, extent, use_screen_prune,
                              device=device_rules.resolve(mesh.device))

    def run(ts: TrainState, grad_threshold, min_opacity,
            normals: Optional[torch.Tensor] = None):
        ts, info = local(ts, grad_threshold, min_opacity, normals)
        keys = list(info)
        total = _all_reduce(torch.stack([info[k] for k in keys]), mesh.model_group)
        return ts, dict(zip(keys, total))

    return run


def make_sharded_opacity_reset(cfg: Config, mesh: Mesh):
    """The opacity reset is elementwise over rows: ``training.make_opacity_reset``
    on each slice (sharding.py:592-604)."""
    device_rules.resolve(mesh.device)
    return make_opacity_reset(cfg)


def batch_cameras(cams: Sequence, device="cuda") -> CameraArrays:
    """Host cameras (``data.cameras.Camera`` or anything with ``world_view``,
    ``full_proj``, ``camera_center`` and ``time``) stacked on a leading axis."""
    dev = device_rules.resolve(device)

    def stack(name):
        return torch.as_tensor(np.stack([np.asarray(getattr(c, name), np.float32) for c in cams]),
                               device=dev)

    return CameraArrays(stack("world_view"), stack("full_proj"), stack("camera_center"),
                        stack("time"))


def global_alive(ts: TrainState, mesh: Mesh) -> int:
    """Alive rows over the model group (every rank gets the same number)."""
    return int(_all_reduce(ts.gaussians.alive.sum().reshape(1), mesh.model_group)[0])
