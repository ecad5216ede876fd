"""Bring a model from the JAX package into the port.

``from_jax_numpy`` takes numpy arrays only (``np.asarray`` of the JAX
leaves), so the port never imports JAX.  The offset net keeps the JAX
weight orientation: ``w`` is (in, out) and a layer is ``x @ w + b``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import device as device_rules
from .config import Config
from .models.deform import OffsetNet
from .models.gaussians import GaussianState


def from_jax_numpy(gaussian_arrays: Dict[str, np.ndarray], deform_params: Optional[dict],
                   cfg: Config, device="cuda") -> Tuple[GaussianState, Optional[OffsetNet]]:
    """(GaussianState, OffsetNet) from the JAX state's fields and net pytree.

    ``gaussian_arrays`` maps GaussianState field names to arrays;
    ``deform_params`` is the ``{"layers": [{"w", "b"}...], "heads": [...]}``
    pytree with numpy leaves, or None for ``deform_mode="none"``.
    """
    dev = device_rules.resolve(device)
    state = GaussianState.from_numpy(gaussian_arrays, device=dev)
    net = None if deform_params is None else OffsetNet(deform_params, cfg.deform, device=dev)
    return state, net
