"""Learning-rate schedule, inverse activation, image metrics and the
CLIs' console (port of ``gs_deformable_tpu/utils/general.py``)."""

from __future__ import annotations

import math
import sys
from datetime import datetime

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1 - x))


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000,
             device="cpu") -> torch.Tensor:
    """Log-linear decay with an optional sine delay, as an fp32 scalar tensor
    on ``device``; 0 for ``step < 0`` (the reference disables the LR there)."""
    step = torch.as_tensor(step, dtype=torch.float32, device=device)
    if lr_init == 0.0 and lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
    lr = delay_rate * log_lerp
    return torch.where(step < 0, 0.0, lr)


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return ((img1 - img2) ** 2).reshape(img1.shape[0], -1).mean(1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    return 20 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def safe_state(silent: bool = False) -> None:
    """Console timestamps for a command-line run (general_utils.py:112-133
    of the reference).

    Wraps ``sys.stdout`` so each finished line ends in "[dd/mm HH:MM:SS]",
    or prints nothing when ``silent``.  Seeds nothing: each CLI makes its
    own seeded generators, and no global random state is touched.
    """
    old = sys.stdout

    class _Stamped:
        def write(self, x):
            if silent:
                return
            if x.endswith("\n"):
                stamp = datetime.now().strftime("%d/%m %H:%M:%S")
                x = x.replace("\n", f" [{stamp}]\n")
            old.write(x)

        def flush(self):
            old.flush()

    sys.stdout = _Stamped()
