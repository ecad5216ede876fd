"""Training CLI: ``python -m gs_deformable_tpu_torch.train -s <scene> [-m <out>]``.

The port of ``gs_deformable_tpu/train.py``, on the card by default
(``--device cuda``; a machine with no GPU raises, ``--device cpu`` runs the
plain PyTorch versions of the kernels).  The host loop of the reference:

- a random camera popped from a refilled stack;
- the SH degree up by one every 1000 iterations;
- the train step (deform -> render -> loss -> backward -> Adam), up to 10
  steps a call through ``training.make_chunk_step`` in windows that end
  at the next host event;
- densify and prune every ``densification_interval`` in
  (``densify_from_iter``, ``densify_until_iter``), the opacity reset every
  ``opacity_reset_interval``, capacity growth past 80% alive;
- the instance counters drained every 10 iterations (every 2 chunks), with
  the instance capacity grown to the next power of two on overflow;
- eval reports at ``--test_iterations``, PLY and net saves at
  ``--save_iterations``, checkpoints at ``--checkpoint_iterations``;
- ``cfg_args`` in the output directory for the render CLI.

The output directory has the JAX CLI's layout, and ``--start_checkpoint``
takes a checkpoint of either package.

``--n_data`` / ``--n_model`` above 1 train over a mesh of processes
(``parallel/sharding.py``), one per device, started by torchrun::

    torchrun --nproc_per_node 2 -m gs_deformable_tpu_torch.train -s <scene> --n_model 2

(``--device cpu`` runs the ranks on the CPU over gloo; several ranks on one
card also talk over gloo).  ``n_data * n_model`` must equal the world size,
or the run raises ``ValueError``.  Every rank draws the same camera sequence
from ``--seed``, in groups of ``n_data``, and takes its own data row's
camera; rank 0 alone writes the output directory, from the state gathered
in JAX's row order.  The viewer is not served under a mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import random
import time
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import device as device_rules
from . import tracing, training
from .config import (
    Config,
    DeformConfig,
    ModelConfig,
    OptimizationConfig,
    ParallelConfig,
    PipelineConfig,
    RasterizeConfig,
    check_supported,
    layout_unit,
)
from .data.cameras import Camera, camera_arrays
from .data.scene import Scene
from .io import checkpoint as ckpt_io
from .io import model_ply
from .models.gaussians import init_from_points
from .ops.binning import aligned_capacity
from .parallel import multihost
from .parallel import sharding as par
from .renderer import CameraArrays

CHUNK_MAX = 10


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Deformable gaussian splatting trainer (PyTorch)")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", default="")
    p.add_argument("--images", "-i", default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--deform_mode", choices=["offset", "se3", "none"], default="offset")
    p.add_argument("--use_opacity_mask", action="store_true")
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    # --debug: read the loss every step; on a non-finite one, dump the
    # render inputs to snapshot_fw.npz and stop.
    p.add_argument("--debug", action="store_true")
    # --detect_anomaly: torch.autograd.set_detect_anomaly (fail at the op
    # whose backward made a NaN).
    p.add_argument("--detect_anomaly", action="store_true")
    o = OptimizationConfig()
    for name in (
        "iterations position_lr_init position_lr_final position_lr_delay_mult "
        "position_lr_max_steps feature_lr opacity_lr scaling_lr rotation_lr "
        "percent_dense lambda_dssim densification_interval opacity_reset_interval "
        "densify_from_iter densify_until_iter densify_grad_threshold min_opacity "
        "densify_offset_gate "
        "lambda_offset_norm offset_lr_init offset_lr_final"
    ).split():
        default = getattr(o, name)
        p.add_argument(f"--{name}", type=type(default), default=default)
    p.add_argument("--n_data", type=int, default=1,
                   help="data-axis ranks (cameras a step); start the ranks with torchrun")
    p.add_argument("--n_model", type=int, default=1,
                   help="model-axis ranks (slices of the gaussians); start with torchrun")
    p.add_argument("--capacity", type=int, default=0,
                   help="gaussian capacity; 0 = 2x the initial points, to a power of two")
    # Start snug and grow on overflow (the sort and binning cost scale with it).
    p.add_argument("--instance_capacity", type=int, default=1 << 19)
    # Padding budget of the aligned layout; -1 = the exact worst case.
    p.add_argument("--aligned_slack", type=int, default=-1)
    p.add_argument("--chunk", type=int, default=RasterizeConfig().chunk)
    p.add_argument("--composite_mode", default=RasterizeConfig().composite_mode,
                   choices=["mixed", "batch", "stream", "packed"])
    p.add_argument("--warmup_iters", type=int, default=DeformConfig().warmup_iters)
    p.add_argument("--mlp_dtype", default=DeformConfig().compute_dtype,
                   choices=["bfloat16", "float32_3x", "float32"],
                   help="deformation-MLP matmul precision tier")
    p.add_argument("--bf16_cotangents", action="store_true",
                   help="bf16 cotangents in the MLP backward")
    p.add_argument("--test_iterations", nargs="+", type=int,
                   default=[7_000, 15_000] + list(range(20_000, 40_001, 10_000)))
    p.add_argument("--save_iterations", nargs="+", type=int,
                   default=[7_000, 15_000] + list(range(20_000, 40_001, 10_000)))
    p.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    p.add_argument("--start_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--random_init_points", type=int,
                   default=ModelConfig().random_init_points)
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--disable_viewer", action="store_true")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace of a step window into this directory")
    p.add_argument("--profile_start", type=int, default=100)
    p.add_argument("--profile_steps", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p


def config_from_args(args) -> Config:
    return Config(
        parallel=ParallelConfig(data_axis=getattr(args, "n_data", 1),
                                model_axis=getattr(args, "n_model", 1)),
        model=ModelConfig(
            sh_degree=args.sh_degree, source_path=args.source_path,
            model_path=args.model_path, images=args.images, resolution=args.resolution,
            white_background=args.white_background, eval=args.eval,
            deform_mode=args.deform_mode, use_opacity_mask=args.use_opacity_mask,
            random_init_points=args.random_init_points),
        deform=DeformConfig(
            warmup_iters=args.warmup_iters, sh_coeffs=(args.sh_degree + 1) ** 2,
            compute_dtype=getattr(args, "mlp_dtype", DeformConfig().compute_dtype),
            bf16_cotangents=getattr(args, "bf16_cotangents", False)),
        pipeline=PipelineConfig(
            convert_shs_python=args.convert_SHs_python,
            compute_cov3d_python=args.compute_cov3D_python,
            debug=getattr(args, "debug", False)),
        raster=RasterizeConfig(
            instance_capacity=args.instance_capacity, chunk=args.chunk,
            aligned_slack=args.aligned_slack, composite_mode=args.composite_mode),
        opt=OptimizationConfig(**{f.name: getattr(args, f.name)
                                  for f in dataclasses.fields(OptimizationConfig)
                                  if hasattr(args, f.name)}),
    )


def prepare_output_dir(args) -> str:
    """The output directory, with the run's arguments in ``cfg_args``."""
    model_path = args.model_path
    if not model_path:
        unique = os.getenv("OAR_JOB_ID") or str(uuid.uuid4())
        model_path = os.path.join("./output/", unique[:10])
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(repr(argparse.Namespace(**vars(args))))
    return model_path


def post_step_event(e: int, cfg: Config, args) -> bool:
    """True when host work runs right after iteration ``e`` (eval, save,
    checkpoint, densify, opacity reset): a chunk may end there, never span it."""
    if (e in args.test_iterations or e in args.save_iterations
            or e in args.checkpoint_iterations):
        return True
    if e < cfg.opt.densify_until_iter:
        if e > cfg.opt.densify_from_iter and e % cfg.opt.densification_interval == 0:
            return True
        if e % cfg.opt.opacity_reset_interval == 0 or (
                args.white_background and e == cfg.opt.densify_from_iter):
            return True
    return False


def chunk_end_iteration(it0: int, cfg: Config, args, chunk_max: int) -> int:
    """Last iteration of the chunk starting at ``it0``: it stops before the
    next SH-degree bump (a multiple of 1000, which runs before its step) and
    at the first post-step event."""
    end = min(it0 + chunk_max - 1, cfg.opt.iterations)
    nxt_sh = ((it0 // 1000) + 1) * 1000
    if nxt_sh <= end:
        end = nxt_sh - 1
    for e in range(it0, end):
        if post_step_event(e, cfg, args):
            return e
    return end


def cam_arrays(cam: Camera, device="cuda") -> CameraArrays:
    return camera_arrays(cam, device=device)


def _frame_key(cam: Camera):
    return cam.width, cam.height, round(cam.fovx, 6), round(cam.fovy, 6)


class Trainer:
    """The train state and the step, chunk, eval and densify functions,
    cached by (frame size, fovs, SH degree).

    With a ``mesh`` (``parallel.sharding``) the state is this rank's slice
    once ``place()`` has run, the functions are the sharded ones, and
    ``full_state()`` gathers the whole state (every rank must call it)."""

    def __init__(self, cfg: Config, scene: Scene, seed: int, device="cuda",
                 capacity: int = 0, mesh: Optional[par.Mesh] = None):
        self.cfg = cfg
        self.scene = scene
        self.device = device_rules.resolve(device)
        self.mesh = mesh
        self.spatial_lr_scale = scene.cameras_extent
        self.active_sh_degree = 0
        self._step_cache: Dict[tuple, object] = {}
        self._chunk_cache: Dict[tuple, object] = {}
        self._eval_cache: Dict[tuple, object] = {}
        self._densify_cache: Dict[bool, object] = {}
        self._reset_fn = None

        pcd = scene.scene_info.point_cloud
        n = pcd.points.shape[0]
        cap = capacity or cfg_capacity(cfg, n)
        print(f"Number of points at initialisation : {n} (capacity {cap})")
        state = init_from_points(pcd.points, pcd.colors, capacity=cap,
                                 sh_degree=cfg.model.sh_degree, device=self.device)
        net, latent = training.init_nets(cfg, seed, self.device)
        self.ts = training.init_train_state(state, net, seed, latent)

    def place(self):
        """Shard the state over the mesh's model axis (with the interleave)."""
        if self.mesh is not None:
            self.ts = par.shard_train_state(self.ts, self.mesh)
            print(f"Mesh: data={self.mesh.n_data} x model={self.mesh.n_model} (rank "
                  f"{self.mesh.rank}: data row {self.mesh.data_index}, slice "
                  f"{self.mesh.model_index}, {self.ts.gaussians.capacity} rows)")

    def full_state(self) -> training.TrainState:
        return self.ts if self.mesh is None else par.gather_train_state(self.ts, self.mesh)

    def _frame_kw(self, cam: Camera) -> dict:
        return dict(width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                    tan_fovy=cam.tan_fovy, active_sh_degree=self.active_sh_degree)

    def step_fn(self, cam: Camera):
        key = _frame_key(cam) + (self.active_sh_degree,)
        if key not in self._step_cache:
            kw = dict(spatial_lr_scale=self.spatial_lr_scale, **self._frame_kw(cam))
            self._step_cache[key] = (
                training.make_train_step(self.cfg, device=self.device, **kw)
                if self.mesh is None else par.make_sharded_train_step(self.cfg, self.mesh, **kw))
        return self._step_cache[key]

    def chunk_fn(self, cam: Camera, chunk_max: int):
        key = _frame_key(cam) + (self.active_sh_degree, chunk_max)
        if key not in self._chunk_cache:
            kw = dict(spatial_lr_scale=self.spatial_lr_scale, chunk_max=chunk_max,
                      **self._frame_kw(cam))
            self._chunk_cache[key] = (
                training.make_chunk_step(self.cfg, device=self.device, **kw)
                if self.mesh is None else par.make_sharded_chunk_step(self.cfg, self.mesh, **kw))
        return self._chunk_cache[key]

    def band_tiles(self, cam: Camera) -> int:
        """Tiles one composite covers: the frame's, or a band's under a mesh."""
        n_model = 1 if self.mesh is None else self.mesh.n_model
        return par.band_tiles(self.cfg, n_model, cam.width, cam.height)

    def eval_batch_fn(self, cam: Camera):
        key = ("batch",) + _frame_key(cam) + (self.active_sh_degree,)
        if key not in self._eval_cache:
            self._eval_cache[key] = training.make_eval_render_batch(
                self.cfg, device=self.device, **self._frame_kw(cam))
        return self._eval_cache[key]

    def densify_fn(self, use_screen_prune: bool):
        if use_screen_prune not in self._densify_cache:
            if self.mesh is not None:
                fn = par.make_sharded_densify_step(self.cfg, self.mesh,
                                                   extent=self.scene.cameras_extent,
                                                   use_screen_prune=use_screen_prune)
            else:
                fn = training.make_densify_step(self.cfg, extent=self.scene.cameras_extent,
                                                use_screen_prune=use_screen_prune,
                                                device=self.device)
            self._densify_cache[use_screen_prune] = fn
        return self._densify_cache[use_screen_prune]

    def reset_fn(self):
        if self._reset_fn is None:
            self._reset_fn = training.make_opacity_reset(self.cfg)
        return self._reset_fn

    def clear_caches(self):
        """Drop every cached function (after the config changes)."""
        self._step_cache.clear()
        self._chunk_cache.clear()
        self._eval_cache.clear()
        self._densify_cache.clear()
        self._reset_fn = None

    def maybe_grow(self) -> Optional[int]:
        """Double the capacity past 80% alive; the new capacity, or None.
        Under a mesh the whole state is gathered, grown and sharded again
        with the interleave, in JAX's row order (train.py:390-401 of the JAX
        package)."""
        g = self.ts.gaussians
        if self.mesh is None:
            alive, cap = int(g.num_alive), g.capacity
        else:
            alive, cap = par.global_alive(self.ts, self.mesh), g.capacity * self.mesh.n_model
        if alive <= 0.8 * cap:
            return None
        print(f"\n[capacity] growing {cap} -> {2 * cap} (alive {alive})")
        self.ts = training.grow_capacity(self.full_state(), 2 * cap)
        self.place()
        return 2 * cap

    def one_up_sh_degree(self):
        if self.active_sh_degree < self.cfg.model.sh_degree:
            self.active_sh_degree += 1


def cfg_capacity(cfg: Config, n_init: int) -> int:
    """2 x the initial points, rounded up to a power of two."""
    cap = 1
    while cap < 2 * n_init:
        cap *= 2
    return cap


def nets_dict(ts: training.TrainState) -> dict:
    """The five nets by file name (``save_ply``'s ``nets``)."""
    return model_ply.nets_dict(ts.net, ts.latent)


def training_report(trainer: Trainer, iteration: int, bg, tb=None,
                    first_test_iter: bool = False, device_gt=None, ts=None):
    """Mean L1 and PSNR over up to 20 test views and 5 train views, ten
    views a call, of ``ts`` (default ``trainer.ts``); with a tensorboardX
    writer also the first five renders of each set, the opacity histogram
    and the point count."""
    ts = ts or trainer.ts
    results = {}
    dev = trainer.device
    gt_of = device_gt or (lambda c: torch.from_numpy(c.image).to(dev))
    for name, cams in (("test", trainer.scene.get_test_cameras()),
                       ("train", trainer.scene.get_train_cameras()[:5])):
        if not cams:
            continue
        cams = cams[:20]
        res = training.eval_sweep(trainer.eval_batch_fn, ts, cams,
                                  lambda c: cam_arrays(c, dev), gt_of, bg, iteration, batch=10)
        if tb is not None:
            for idx, cam in enumerate(cams[:5]):
                tb.add_images(f"{name}_view_{cam.image_name}/render", res[idx][0][None],
                              global_step=iteration)
                if first_test_iter:
                    tb.add_images(f"{name}_view_{cam.image_name}/ground_truth",
                                  np.clip(cam.image, 0, 1)[None], global_step=iteration)
        results[name] = (float(np.mean([r[1] for r in res])),
                         float(np.mean([r[2] for r in res])))
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {results[name][0]:.5f} "
              f"PSNR {results[name][1]:.2f}")
        if tb is not None:
            tb.add_scalar(f"{name}/loss_viewpoint - l1_loss", results[name][0], iteration)
            tb.add_scalar(f"{name}/loss_viewpoint - psnr", results[name][1], iteration)
    if tb is not None:
        gs = ts.gaussians
        op = torch.sigmoid(gs.opacity)[gs.alive].cpu().numpy()
        if op.size:
            tb.add_histogram("scene/opacity_histogram", op, iteration)
        tb.add_scalar("total_points", int(gs.num_alive), iteration)
    return results


def _serve_viewer(trainer: Trainer, bg, iteration: int, cfg: Config, source_path: str) -> None:
    """Serve the viewer's renders until it hands control back to training."""
    from . import viewer

    if viewer.conn is None:
        viewer.try_connect()
    while viewer.conn is not None:
        try:
            net_image_bytes = None
            camera, do_training, _shs, _cov, keep_alive, _smod = viewer.receive()
            if camera is not None:
                cam = CameraArrays.from_numpy(camera["world_view"], camera["full_proj"],
                                              camera["camera_center"], camera["time"],
                                              device=trainer.device)
                fn = training.make_eval_render(
                    cfg, width=camera["width"], height=camera["height"],
                    tan_fovx=float(np.tan(camera["fovx"] * 0.5)),
                    tan_fovy=float(np.tan(camera["fovy"] * 0.5)),
                    active_sh_degree=trainer.active_sh_degree, device=trainer.device)
                img = fn(trainer.ts.gaussians, trainer.ts.net, cam, bg, iteration,
                         trainer.ts.latent)
                net_image_bytes = viewer.image_to_bytes(img.cpu().numpy())
            viewer.send(net_image_bytes, source_path)
            if do_training and (iteration < cfg.opt.iterations or not keep_alive):
                break
        except Exception:
            viewer.conn = None


def _dump_snapshot(path: str, ts: training.TrainState, cam: Camera, iteration: int) -> None:
    """The render inputs of a failing step, for --debug."""
    flat = {f"gaussians/{f.name}": getattr(ts.gaussians, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(ts.gaussians)}
    if ts.net is not None:
        model_ply.map_tree(ts.net.param_tree(),
                           lambda k, v: flat.__setitem__("deform/" + k, model_ply.to_numpy(v)))
    flat.update(world_view=cam.world_view, full_proj=cam.full_proj,
                camera_center=cam.camera_center, time=np.float32(cam.time),
                iteration=np.int64(iteration))
    np.savez(path, **flat)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def join_mesh(cfg: Config, device) -> Optional[par.Mesh]:
    """The mesh of ``cfg.parallel``, joining the process group from torchrun's
    variables first if needed; None for one process and a 1x1 mesh.  Raises
    ``ValueError`` when ``n_data * n_model`` is not the world size."""
    n_data, n_model = cfg.parallel.data_axis, cfg.parallel.model_axis
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if n_data * n_model == 1 and world == 1 and not dist.is_initialized():
        return None
    if not dist.is_initialized() and world > 1:
        device = multihost.initialize_from_env(device)
    return multihost.global_mesh(n_data, n_model, device)


def _shared_output_dir(args, mesh: Optional[par.Mesh]) -> str:
    """Rank 0 makes the output directory (``prepare_output_dir``); every rank
    gets its path."""
    path = [prepare_output_dir(args) if mesh is None or mesh.rank == 0 else None]
    if mesh is not None and mesh.world_group is not None:
        dist.broadcast_object_list(path, src=0)
    return path[0]


def train(args, timeline: Optional[List[dict]] = None) -> str:
    """Run the training loop of ``args``; returns the output directory.

    A list given as ``timeline`` gets one dict per stage, in order, with its
    ``"stage"``, ``"iteration"`` and wall ``"ms"`` (the card synchronised at
    both ends): ``scene_load``, ``init``, ``steps`` (each window between two
    counter drains: ``"from"``, ``"to"``, each step's ``"losses"`` and the
    ``"overflow"`` frames),
    ``test_report``, ``save``, ``densify``, ``reset``, ``checkpoint``,
    ``instance_growth`` (``"required"``, ``"capacity"``) and
    ``capacity_growth`` (``"capacity"``).
    """
    cfg = config_from_args(args)
    check_supported(cfg)
    dev = device_rules.resolve(args.device)
    joined = not dist.is_initialized()
    mesh = join_mesh(cfg, dev)
    if mesh is not None:
        dev = mesh.device
    writer = mesh is None or mesh.rank == 0
    model_path = _shared_output_dir(args, mesh)
    print("Output folder:", model_path)
    cam_rng = random.Random(args.seed)

    mark = [time.perf_counter()]

    def note(stage, iteration, **kw):
        if timeline is None:
            return
        _sync(dev)
        now = time.perf_counter()
        timeline.append(dict(stage=stage, iteration=iteration, ms=(now - mark[0]) * 1e3, **kw))
        mark[0] = now

    scene = Scene(source_path=args.source_path, model_path=model_path if writer else "",
                  images=args.images, eval=args.eval, white_background=args.white_background,
                  resolution=args.resolution, random_init_points=cfg.model.random_init_points,
                  rng=np.random.RandomState(args.seed), shuffle_rng=random.Random(args.seed))
    note("scene_load", 0)
    trainer = Trainer(cfg, scene, args.seed, dev, args.capacity, mesh)

    first_iter = 0
    if args.start_checkpoint:
        trainer.ts, first_iter = ckpt_io.load_checkpoint(args.start_checkpoint, trainer.ts)
        print(f"Resumed from {args.start_checkpoint} at iteration {first_iter}")
        trainer.active_sh_degree = min(first_iter // 1000, cfg.model.sh_degree)
    trainer.place()
    note("init", 0)

    tb = None
    if writer:
        try:
            from tensorboardX import SummaryWriter

            tb = SummaryWriter(model_path)
        except Exception:
            print("tensorboardX not available: not logging progress")

    def save_ply(iteration):
        full = trainer.full_state()
        if writer:
            model_ply.save_ply(scene.point_cloud_dir(iteration), full.gaussians,
                               nets=nets_dict(full))

    bg = torch.tensor([1.0, 1.0, 1.0] if args.white_background else [0.0, 0.0, 0.0],
                      device=dev)
    viewpoint_stack: List[Camera] = []
    ema_loss = 0.0
    t_start = time.time()
    # Each dispatch's instance counters stay on the card until the drain:
    # (required, required aligned, overflow frames or None for one step).
    pending_req = []
    pending_losses: List[torch.Tensor] = []
    overflow_frames = 0

    # Ground truths and camera arrays go to the card at first use and stay
    # there, within a budget: 2 GiB, or half the card's free memory at the
    # start if that is less.  Past it, images are uploaded per use.
    budget = 2 << 30
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        budget = min(budget, max(free // 2, 256 << 20))
    gt_cache: Dict[int, torch.Tensor] = {}
    gt_bytes = [0]
    cam_cache: Dict[int, CameraArrays] = {}

    def device_gt(cam):
        hit = gt_cache.get(id(cam))
        if hit is not None:
            return hit
        arr = torch.from_numpy(cam.image).to(dev)
        nbytes = arr.numel() * arr.element_size()
        if gt_bytes[0] + nbytes <= budget:
            gt_cache[id(cam)] = arr
            gt_bytes[0] += nbytes
        return arr

    def device_cam_arrays(cam):
        if id(cam) not in cam_cache:
            cam_cache[id(cam)] = cam_arrays(cam, dev)
        return cam_cache[id(cam)]

    def next_camera():
        if not viewpoint_stack:
            viewpoint_stack.extend(trainer.scene.get_train_cameras())
        return viewpoint_stack.pop(cam_rng.randint(0, len(viewpoint_stack) - 1))

    # One camera a data row per iteration: every rank draws the same groups
    # and takes its own row's (train.py:704-770 of the JAX package).
    n_data = 1 if mesh is None else mesh.n_data
    row = 0 if mesh is None else mesh.data_index

    def next_group():
        group = [next_camera() for _ in range(n_data)]
        if any(_frame_key(c) != _frame_key(group[0]) for c in group):
            raise ValueError("--n_data > 1 needs uniform camera resolutions in a batch")
        return group

    viewer_on = not args.disable_viewer
    if viewer_on and mesh is not None:
        print("viewer disabled: not served under a mesh")
        viewer_on = False
    if viewer_on:
        try:
            from . import viewer

            viewer.init(args.ip, args.port)
        except Exception as e:
            print(f"viewer disabled: {e}")
            viewer_on = False

    # Chunks off for --debug (a finite check every step) and --profile_dir
    # (one step a call in the trace).
    chunking = not cfg.pipeline.debug and not args.profile_dir
    prof = None
    losses_out = pending_losses if timeline is not None else None
    steps_from = first_iter + 1

    iteration = first_iter
    while iteration < cfg.opt.iterations:
        it0 = iteration + 1
        if viewer_on:
            _serve_viewer(trainer, bg, it0, cfg, args.source_path)
        if args.profile_dir:
            if it0 == args.profile_start:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            elif it0 == args.profile_start + args.profile_steps and prof is not None:
                prof.stop()
                if writer:
                    os.makedirs(args.profile_dir, exist_ok=True)
                    path = os.path.join(args.profile_dir, f"trace_{args.profile_start}.json")
                    prof.export_chrome_trace(path)
                    print(f"\n[profile] trace written to {path}")
                prof = None
        if it0 % 1000 == 0:
            trainer.one_up_sh_degree()

        end = chunk_end_iteration(it0, cfg, args, CHUNK_MAX) if chunking else it0
        h = end - it0 + 1
        groups = [next_group() for _ in range(h)]
        pairs = [(grp[row], device_gt(grp[row])) for grp in groups]
        cam = pairs[0][0]
        if h >= 2 and all(_frame_key(c) == _frame_key(cam) for c, _ in pairs):
            pad = CHUNK_MAX - h
            cam_list = [device_cam_arrays(c) for c, _ in pairs] + \
                [device_cam_arrays(pairs[-1][0])] * pad
            cam_stack = CameraArrays(*(torch.stack(xs) for xs in zip(*cam_list)))
            gt_stack = torch.stack([g for _, g in pairs] + [pairs[-1][1]] * pad)
            trainer.ts, metrics = trainer.chunk_fn(cam, CHUNK_MAX)(
                trainer.ts, cam_stack, gt_stack, bg, it0, h, losses_out)
            pending_req.append((metrics["required_instances"], metrics["required_aligned"],
                                metrics["overflow_frames"]))
        else:
            # Mixed frame sizes in the window, or one step: the same cameras
            # one step a call.
            for k, (c, g) in enumerate(pairs):
                trainer.ts, metrics = trainer.step_fn(c)(trainer.ts, device_cam_arrays(c), g,
                                                         bg, it0 + k)
                pending_req.append((metrics["required_instances"],
                                    metrics["required_aligned"], None))
                if losses_out is not None:
                    losses_out.append(metrics["loss"])
            cam = pairs[-1][0]
        iteration = end

        if cfg.pipeline.debug and not np.isfinite(float(metrics["loss"])):
            snap = os.path.join(model_path, "snapshot_fw.npz")
            full = trainer.full_state()
            if writer:
                _dump_snapshot(snap, full, cam, iteration)
            raise RuntimeError(f"[debug] non-finite loss at iteration {iteration}; "
                               f"render inputs dumped to {snap}")

        # Drain the counters every 10 iterations, after every 2 chunks (a
        # chunk covers up to 10 iterations), at each event and at the end.
        n_chunks = sum(o is not None for _, _, o in pending_req)
        if (iteration % 10 == 0 or n_chunks >= 2 or len(pending_req) >= 10
                or post_step_event(iteration, cfg, args) or iteration == cfg.opt.iterations):
            with tracing.span("gs.drain"):
                loss = float(metrics["loss"])
                ema_loss = 0.4 * loss + 0.6 * ema_loss
                r = cfg.raster
                unit = layout_unit(r)
                kp_now = aligned_capacity(r.instance_capacity, trainer.band_tiles(cam), unit,
                                          r.aligned_slack)
                drained = [(int(a), int(b), None if o is None else int(o))
                           for a, b, o in pending_req]
                pending_req.clear()
                req = max(a for a, _, _ in drained)
                req_al = max(b for _, b, _ in drained)
                n_of = sum(o if o is not None else int(a > r.instance_capacity or b > kp_now)
                           for a, b, o in drained)
                note("steps", iteration, overflow=n_of,
                     losses=[float(x) for x in pending_losses], **{"from": steps_from,
                                                                   "to": iteration})
                pending_losses.clear()
                steps_from = iteration + 1
                if n_of:
                    overflow_frames += n_of
                    print(f"\n[iter {iteration}] {n_of} frame(s) since last poll exceeded "
                          f"instance capacity and were truncated ({overflow_frames} total)")
                if req > r.instance_capacity or req_al > kp_now:
                    new_cap = r.instance_capacity
                    while new_cap < req:
                        new_cap *= 2
                    new_slack = r.aligned_slack
                    if req_al > kp_now and new_slack >= 0:
                        deficit = req_al - ((new_cap + unit - 1) // unit) * unit
                        new_slack = max(new_slack, unit)
                        while new_slack < deficit:
                            new_slack *= 2
                    print(f"\n[iter {iteration}] instance overflow (required {req} "
                          f"> {r.instance_capacity} or aligned {req_al} > {kp_now}); "
                          f"growing to {new_cap}/slack {new_slack}")
                    cfg = cfg.replace(raster=dataclasses.replace(
                        r, instance_capacity=new_cap, aligned_slack=new_slack))
                    trainer.cfg = cfg
                    trainer.clear_caches()
                    note("instance_growth", iteration, required=req, required_aligned=req_al,
                         capacity=new_cap, aligned_slack=new_slack)
                if not args.quiet and writer and iteration % 200 == 0:
                    el = time.time() - t_start
                    print(f"iter {iteration}: loss {ema_loss:.5f} "
                          f"alive {int(metrics['n_alive'])} "
                          f"({(iteration - first_iter) / max(el, 1e-9):.1f} it/s)", flush=True)
                if tb is not None:
                    tb.add_scalar("train_loss_patches/total_loss", loss, iteration)
                    tb.add_scalar("train_loss_patches/l1_loss", float(metrics["ll1"]), iteration)
                    tb.add_scalar("total_points", int(metrics["n_alive"]), iteration)
                    tb.add_scalar("overflow_frames", overflow_frames, iteration)
                    tb.add_scalar("iter_time", (time.time() - t_start)
                                  / max(iteration - first_iter, 1) * 1e3, iteration)

        if iteration in args.test_iterations:
            full = trainer.full_state()
            if writer:
                training_report(trainer, iteration, bg, tb,
                                first_test_iter=(iteration == min(args.test_iterations)),
                                device_gt=device_gt, ts=full)
            note("test_report", iteration)

        if iteration in args.save_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            save_ply(iteration)
            note("save", iteration)

        if iteration < cfg.opt.densify_until_iter:
            if (iteration > cfg.opt.densify_from_iter
                    and iteration % cfg.opt.densification_interval == 0):
                use_screen = iteration > cfg.opt.opacity_reset_interval
                with tracing.span("gs.densify"):
                    trainer.ts, info = trainer.densify_fn(use_screen)(
                        trainer.ts, cfg.opt.densify_grad_threshold, cfg.opt.min_opacity)
                if int(info["n_dropped"]) > 0:
                    print(f"\n[WARN iter {iteration}] densify dropped "
                          f"{int(info['n_dropped'])} children (capacity full)")
                note("densify", iteration, **{k: int(v) for k, v in info.items()})
                new_cap = trainer.maybe_grow()
                if new_cap is not None:
                    note("capacity_growth", iteration, capacity=new_cap)
            if iteration % cfg.opt.opacity_reset_interval == 0 or (
                    args.white_background and iteration == cfg.opt.densify_from_iter):
                trainer.ts = trainer.reset_fn()(trainer.ts)
                note("reset", iteration)

        if iteration in args.checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            full = trainer.full_state()
            if writer:
                path = os.path.join(model_path, "ckpt_save", f"chkpnt_{iteration}.npz")
                ckpt_io.save_checkpoint(path, full, iteration)
            note("checkpoint", iteration)

    if prof is not None:
        prof.stop()
    if tb is not None:
        tb.close()
    save_ply(cfg.opt.iterations)
    note("save", cfg.opt.iterations)
    print(f"\nTraining complete in {time.time() - t_start:.1f}s")
    if mesh is not None and mesh.world_group is not None:
        dist.barrier()
        if joined:
            dist.destroy_process_group()
    return model_path


def main(argv=None, timeline: Optional[List[dict]] = None) -> str:
    """Parse ``argv`` (``sys.argv`` when None) and train; returns the output
    directory.  A command-line run (``argv`` None) gets timestamped output."""
    args = build_argparser().parse_args(argv)
    if args.detect_anomaly:
        torch.autograd.set_detect_anomaly(True)
    if argv is None:
        from .utils.general import safe_state

        safe_state(args.quiet)
    return train(args, timeline)


if __name__ == "__main__":
    main()
