"""Training-side entry points.  This slice holds only the eval render
(port of ``training.make_eval_render``); the train step arrives next."""

from __future__ import annotations

from typing import Optional

import torch

from . import device as device_rules
from .config import Config, check_supported
from .models.deform import OffsetNet
from .models.gaussians import GaussianState
from .renderer import CameraArrays, render


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
        out, _ = render(state, net, cam, iteration=iteration, bg=bg, width=width,
                        height=height, tan_fovx=tan_fovx, tan_fovy=tan_fovy,
                        active_sh_degree=active_sh_degree, cfg=cfg, device=dev)
        return out.image

    return run
