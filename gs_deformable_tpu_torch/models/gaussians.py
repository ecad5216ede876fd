"""Fixed-capacity gaussian state (port of ``GaussianState``, models/gaussians.py:42-87).

Capacity ``P`` rows with an ``alive`` mask; dead slots are inert in the
render (``renderer.deformed_attributes`` routes them to finite constants).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .. import device as device_rules

_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "alive",
           "max_radii2d", "xyz_gradient_accum", "denom", "last_offset_norm")


@dataclasses.dataclass
class GaussianState:
    xyz: torch.Tensor  # (P, 3)
    f_dc: torch.Tensor  # (P, 1, 3)
    f_rest: torch.Tensor  # (P, K-1, 3)
    opacity: torch.Tensor  # (P, 1) logit
    scaling: torch.Tensor  # (P, 3) log
    rotation: torch.Tensor  # (P, 4) unnormalized quat
    alive: torch.Tensor  # (P,) bool
    max_radii2d: torch.Tensor  # (P,)
    xyz_gradient_accum: torch.Tensor  # (P, 1)
    denom: torch.Tensor  # (P, 1)
    last_offset_norm: torch.Tensor  # (P,)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device="cuda") -> "GaussianState":
        """Build from numpy arrays; the six parameter groups and ``alive`` are
        required, the statistics default to zeros.  ``device`` defaults to
        ``"cuda"`` and raises without a GPU (see ``device.resolve``)."""
        device = device_rules.resolve(device)
        P = np.asarray(arrays["xyz"]).shape[0]
        defaults = {"max_radii2d": np.zeros(P, np.float32),
                    "xyz_gradient_accum": np.zeros((P, 1), np.float32),
                    "denom": np.zeros((P, 1), np.float32),
                    "last_offset_norm": np.zeros(P, np.float32)}
        out = {}
        for name in _FIELDS:
            a = np.asarray(arrays[name] if name in arrays else defaults[name])
            a = a.astype(bool) if name == "alive" else a.astype(np.float32)
            out[name] = torch.as_tensor(a, device=device)
        return cls(**out)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.vector_norm(self.rotation, dim=-1, keepdim=True)

    def get_features(self) -> torch.Tensor:
        """(P, K, 3): DC then rest."""
        return torch.cat([self.f_dc, self.f_rest], dim=1)
