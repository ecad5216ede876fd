"""Render a trained model: ``python -m gs_deformable_tpu_torch.render_cli -m <model>``.

The port of ``gs_deformable_tpu/render_cli.py``, on the card by default
(``--device cuda``; ``--device cpu`` runs the plain versions of the
kernels).  Loads the model of the chosen iteration (the PLY and all five
nets, written by either package's trainer), renders the train and test
cameras to ``<model>/<set>/ours_<iteration>/{renders,gt}/NNNNN.png``,
prints each set's PSNR and SSIM, and with ``--save_ply`` writes each
view's deformed means as ``ply/points_NNNNN.ply``.

Any training flag after the render flags (``--resolution``,
``--white_background``, ``-s`` ...) overlays the saved ``cfg_args``.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import List

import numpy as np
import torch
from PIL import Image

from . import device as device_rules
from . import training
from .data.cameras import Camera
from .data.scene import Scene
from .io import model_ply
from .io.ply import read_ply
from .models import deform as deform_mod
from .train import build_argparser, cam_arrays, config_from_args

FINAL = 10 ** 9  # an iteration past any warmup: every net runs


def search_max_iteration(folder: str) -> int:
    """The largest N of the ``iteration_N`` directories in ``folder``."""
    return max(int(d.split("_")[-1]) for d in os.listdir(folder) if d.startswith("iteration_"))


def load_cfg_args(model_path: str) -> dict:
    """The ``cfg_args`` namespace a trainer wrote, parsed without ``eval``."""
    with open(os.path.join(model_path, "cfg_args")) as f:
        text = f.read().strip()
    if not text.startswith("Namespace("):
        raise ValueError(f"{model_path}/cfg_args is not a Namespace repr")
    node = ast.parse(f"f({text[len('Namespace('):-1]})", mode="eval").body
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}


def combined_args(model_path: str, extra_argv: List[str]) -> argparse.Namespace:
    """The trainer's defaults, overlaid by the saved ``cfg_args``, overlaid
    by the training flags given in ``extra_argv``."""
    tp = build_argparser()
    defaults = {a.dest: a.default for a in tp._actions if a.dest != "help"}
    # Parse with every default suppressed, so only the flags typed appear.
    for a in tp._actions:
        a.required = False
        a.default = argparse.SUPPRESS
    overrides, unknown = tp.parse_known_args(extra_argv)
    if unknown:
        raise SystemExit(f"unknown eval-time override flags: {unknown}")
    merged = dict(defaults)
    merged.update(load_cfg_args(model_path))
    merged.update(vars(overrides))
    return argparse.Namespace(**merged)


def restore_nets(ts: training.TrainState, pc_dir: str):
    """(state, files read): the deformation net from ``offset_model.npz`` and
    the four latent heads from their files, each one whose file exists
    (an older export keeps the state's own)."""
    dev = ts.gaussians.xyz.device
    n = 0
    net = ts.net
    path = os.path.join(pc_dir, "offset_model.npz")
    if net is not None and os.path.exists(path):
        net = model_ply.load_net(path, net.cfg, dev, kind=type(net))
        n += 1
    latent = ts.latent
    if latent is not None:
        latent, k = model_ply.load_latent(pc_dir, latent, dev)
        n += k
    return training.TrainState(ts.gaussians, net, ts.adam, ts.generator, latent), n


def deformed_means(ts: training.TrainState, cfg, time_: float) -> torch.Tensor:
    """The means at ``time_`` past the warmup, as the deformation moves them."""
    xyz = ts.gaussians.xyz
    with torch.no_grad():
        if cfg.model.deform_mode == "offset":
            return xyz + deform_mod.deform_offsets(ts.net, xyz, time_, FINAL, cfg.deform)[0]
        if cfg.model.deform_mode == "se3":
            return deform_mod.deform_se3(ts.net, xyz, time_, FINAL, cfg.deform)
    return xyz


def _png(img_chw: np.ndarray, path: str) -> None:
    Image.fromarray((img_chw.transpose(1, 2, 0) * 255).astype(np.uint8)).save(path)


def render_set(model_path: str, name: str, iteration: int, cams: List[Camera],
               ts: training.TrainState, cfg, active_sh: int, bg: torch.Tensor,
               save_ply_frames: bool = False) -> List[float]:
    """Render ``cams`` ten views a call into ``<name>/ours_<iteration>``; the
    PSNR of each view that has a ground truth."""
    out_dir = os.path.join(model_path, name, f"ours_{iteration}")
    render_path, gts_path = os.path.join(out_dir, "renders"), os.path.join(out_dir, "gt")
    os.makedirs(render_path, exist_ok=True)
    os.makedirs(gts_path, exist_ok=True)
    dev = ts.gaussians.xyz.device
    eval_cache = {}

    def make_batch_fn(cam):
        key = (cam.width, cam.height, round(cam.fovx, 6), round(cam.fovy, 6))
        if key not in eval_cache:
            eval_cache[key] = training.make_eval_render_batch(
                cfg, width=cam.width, height=cam.height, tan_fovx=cam.tan_fovx,
                tan_fovy=cam.tan_fovy, active_sh_degree=active_sh, device=dev)
        return eval_cache[key]

    def gt_of(cam):
        if cam.image is not None:
            return cam.image
        return np.zeros((3, cam.height, cam.width), np.float32)

    sweep = training.eval_sweep(make_batch_fn, ts, cams, lambda c: cam_arrays(c, dev), gt_of,
                                bg, FINAL, batch=10)
    psnrs, ssims = [], []
    for idx, (cam, (img, _l1, ps, ss)) in enumerate(zip(cams, sweep)):
        _png(img, os.path.join(render_path, f"{idx:05d}.png"))
        if cam.image is not None:
            _png(np.clip(cam.image, 0, 1), os.path.join(gts_path, f"{idx:05d}.png"))
            psnrs.append(ps)
            ssims.append(ss)
        if save_ply_frames:
            model_ply.save_ply(os.path.join(out_dir, "ply"), ts.gaussians,
                               xyz_override=deformed_means(ts, cfg, cam.time),
                               filename=f"points_{idx:05d}.ply")
    if psnrs:
        print(f"[{name}] PSNR: {np.mean(psnrs):.3f} SSIM: {np.mean(ssims):.4f} "
              f"over {len(psnrs)} views")
    return psnrs


def _next_pow2_from_ply(path: str) -> int:
    n = len(read_ply(path)["x"])
    cap = 1
    while cap < max(n, 2):
        cap *= 2
    return cap


def main(argv=None) -> dict:
    """Parse ``argv`` (``sys.argv`` when None) and render; returns
    ``{set name: per-view PSNRs}``."""
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--iteration", type=int, default=-1)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--skip_test", action="store_true")
    p.add_argument("--save_ply", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args, extra = p.parse_known_args(argv)
    dev = device_rules.resolve(args.device)
    if argv is None:
        from .utils.general import safe_state

        safe_state(args.quiet)

    targs = combined_args(args.model_path, extra)
    cfg = config_from_args(targs)
    white_bg = cfg.model.white_background
    iteration = args.iteration
    pc_root = os.path.join(args.model_path, "point_cloud")
    if iteration == -1:
        iteration = search_max_iteration(pc_root)
    print(f"Loading trained model at iteration {iteration}")
    pc_dir = os.path.join(pc_root, f"iteration_{iteration}")

    scene = Scene(source_path=targs.source_path, model_path="", images=cfg.model.images,
                  eval=cfg.model.eval, white_background=white_bg,
                  resolution=cfg.model.resolution, shuffle=False)
    ply_path = os.path.join(pc_dir, "point_cloud.ply")
    state, active_sh = model_ply.load_ply(ply_path, capacity=_next_pow2_from_ply(ply_path),
                                          sh_degree=cfg.model.sh_degree, device=dev)
    net, latent = training.init_nets(cfg, 0, dev)
    ts, _ = restore_nets(training.init_train_state(state, net, 0, latent), pc_dir)

    bg = torch.tensor([1.0, 1.0, 1.0] if white_bg else [0.0, 0.0, 0.0], device=dev)
    out = {}
    for name, skip, cams in (("train", args.skip_train, scene.get_train_cameras()),
                             ("test", args.skip_test, scene.get_test_cameras())):
        if not skip:
            out[name] = render_set(args.model_path, name, iteration, cams, ts, cfg, active_sh,
                                   bg, save_ply_frames=args.save_ply)
    return out


if __name__ == "__main__":
    main()
