"""Device rules of the port.

Entry points take ``device=`` and default to ``"cuda"``.  A CUDA device that
is not there raises; nothing falls back to the CPU quietly.  The CPU runs
only when a caller asks for it, as the tests do, and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no GPU exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def pin_fp32() -> None:
    """Turn TF32 off for matmuls and cuDNN.

    TF32 keeps ~10 mantissa bits: it would silently round every fp32 matmul
    of the port (the GPU analog of the TPU's one-bf16-pass default dot).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_on(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device.type != dev.type:
        raise ValueError(f"{name} lies on {t.device}, expected {dev}")
