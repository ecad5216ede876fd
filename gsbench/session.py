"""What the traffic generators share: the scene and nets made from the seed,
and the program's objects built from them.

The program gets copies of the benchmark's tensors, so nothing it does in
place reaches the inputs the reference reads.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from . import scene
from .reference import render as ref_render


def net_layouts(config: dict) -> Dict[str, tuple]:
    """(input width, skip width, head widths) of each net the configuration runs."""
    sh = (config["sh_degree"] + 1) ** 2
    if config["deform_mode"] == "offset":
        xe = 3 * (1 + 2 * config["multires_xyz"])
        out = {"net": (xe + 1 + 2 * config["multires_time"], xe, (3, 3, 4, 3 * sh))}
    else:
        out = {"net": (4, 3, (3, 3))}
    if config["use_opacity_mask"]:
        out["gate"] = (4, 3, (1,))
    return out


def port_config(config: dict, mix: dict):
    from gs_deformable_tpu_torch import config as pc

    return pc.Config(
        model=pc.ModelConfig(sh_degree=config["sh_degree"], deform_mode=config["deform_mode"],
                             use_opacity_mask=config["use_opacity_mask"],
                             random_init_points=mix["gaussians"]),
        deform=pc.DeformConfig(depth=config["depth"], width=config["width"],
                               skips=tuple(config["skips"]),
                               multires_xyz=config["multires_xyz"],
                               multires_time=config["multires_time"],
                               warmup_iters=config["warmup_iters"],
                               sh_coeffs=(config["sh_degree"] + 1) ** 2,
                               compute_dtype=config["compute_dtype"]),
        raster=pc.RasterizeConfig(instance_capacity=mix["instance_capacity"],
                                  chunk=config["chunk"],
                                  composite_mode=config["composite_mode"],
                                  sort_mode=config["sort_mode"],
                                  grad_reduce=config["grad_reduce"]),
        opt=pc.OptimizationConfig())


class Base:
    """Set-up common to every kind: ``self.clouds`` ("truth", "state"),
    ``self.weights`` (the nets' tensors by net), ``self.rng`` for host draws,
    and the program's state, nets and config."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.device = torch.device(device)
        self.setup_times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_times[f"{name}_s"] = time.perf_counter() - t0

    def make_scene(self) -> None:
        c = self.config
        gen = scene.generator(self.seed, self.device)
        self.rng = np.random.default_rng(self.seed)
        self.clouds = scene.cloud(self.mix["gaussians"], c["sh_degree"], gen, self.device)
        self.weights = {}
        for name, (i, s, heads) in net_layouts(c).items():
            shapes = scene.mlp_shapes(i, s, heads, c["depth"], c["width"], c["skips"])
            scale = c["head_scale"] if name == "net" else 1.0
            self.weights[name] = scene.mlp_weights(shapes, scale, gen, self.device)
        self.nets_ref = self.weights
        self.prec = ref_render.stated(c)

    def gaussians(self, which: str = "state") -> Dict[str, torch.Tensor]:
        return self.clouds[which]._asdict()

    def make_program(self) -> None:
        """The program's config, gaussian state (the trained state padded to
        the mix's capacity with dead rows), net and gate."""
        from gs_deformable_tpu_torch.models import deform as D
        from gs_deformable_tpu_torch.models.gaussians import GaussianState

        self.pcfg = port_config(self.config, self.mix)
        cl = self.clouds["state"]
        n, cap = cl.xyz.shape[0], self.mix["capacity"]

        def pad(x):
            return torch.cat([x, x.new_zeros((cap - n,) + x.shape[1:])])

        rot = pad(cl.rotation)
        rot[n:, 0] = 1.0
        zeros = torch.zeros(cap, device=self.device)
        self.state = GaussianState(
            xyz=pad(cl.xyz), f_dc=pad(cl.f_dc), f_rest=pad(cl.f_rest), opacity=pad(cl.opacity),
            scaling=pad(cl.scaling), rotation=rot,
            alive=pad(torch.ones(n, dtype=torch.bool, device=self.device)),
            max_radii2d=zeros, xyz_gradient_accum=zeros[:, None].clone(),
            denom=zeros[:, None].clone(), last_offset_norm=zeros.clone())

        def build(cls, w):
            zero = {part: [{"w": np.zeros(tuple(x["w"].shape), np.float32),
                            "b": np.zeros(tuple(x["b"].shape), np.float32)} for x in w[part]]
                    for part in ("layers", "heads")}
            net = cls(zero, self.pcfg.deform, device=self.device)
            with torch.no_grad():
                for mod, part in ((net.layers, "layers"), (net.heads, "heads")):
                    for m, x in zip(mod, w[part]):
                        m.w.copy_(x["w"])
                        m.b.copy_(x["b"])
            return net

        cls = D.OffsetNet if self.config["deform_mode"] == "offset" else D.SE3Net
        self.net = build(cls, self.weights["net"])
        self.latent = None
        if "gate" in self.weights:
            self.latent = {"opacity_mask": build(D.DeformMLP, self.weights["gate"])
                           .requires_grad_(False)}

    def camera(self, view: scene.View):
        from gs_deformable_tpu_torch.renderer import CameraArrays

        return CameraArrays.from_numpy(view.world_view, view.full_proj, view.center, view.time,
                                       device=self.device)

    def reference_image(self, view: scene.View, which: str, prec=None, work=None):
        """The reference's image of the ``which`` cloud in ``view``, no gradient."""
        with torch.no_grad():
            img, _ = ref_render.render(self.config, self.nets_ref, self.gaussians(which),
                                       ref_render.view_tensors(view, self.device), self.bg,
                                       prec or self.prec, work)
        return img

    def count(self, views: List[scene.View], g: Dict[str, torch.Tensor], nets: dict) -> dict:
        """The reference's pair counts summed over ``views`` (see ``reference.render.image``)."""
        n = g["xyz"].shape[0]
        total = {"needed_pairs": 0, "walked": 0, "walked_bwd": 0, "contributing": 0,
                 "touched": 0, "pixels": 0}
        for v in views:
            work = ref_render.new_work(n, self.device)
            with torch.no_grad():
                ref_render.render(self.config, nets, g, ref_render.view_tensors(v, self.device),
                                  self.bg, self.prec, work)
            work["touched"] = int(work["touched"].sum())
            for k in ("needed_pairs", "walked", "walked_bwd", "contributing", "touched"):
                total[k] += work[k]
            total["pixels"] += v.width * v.height
        return total
