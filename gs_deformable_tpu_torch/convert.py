"""Carry a model or a train state between the JAX package and the port.

Everything here takes or returns numpy arrays only (``np.asarray`` of the
JAX leaves), so the port never imports JAX.  The offset net keeps the JAX
weight orientation: ``w`` is (in, out) and a layer is ``x @ w + b``; its
Adam moments keep the JAX ``{"layers": [{"w", "b"}...], "heads": [...]}``
layout under the ``"offset_model"`` group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import device as device_rules
from .config import Config
from .models.deform import OffsetNet
from .models.gaussians import AdamState, GaussianState, tree_map
from .training import TrainState, make_generator


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


def train_state_from_jax_numpy(gaussian_arrays: Dict[str, np.ndarray],
                               deform_params: Optional[dict], adam: Dict, cfg: Config,
                               device="cuda", seed: int = 0) -> TrainState:
    """A JAX ``TrainState`` as numpy leaves -> the port's ``TrainState``.

    ``adam`` is ``{"mu": {group: array or net subtree}, "nu": {...}, "step":
    int}`` as JAX's ``AdamState``; a ``"offset_model"`` group is kept only
    when ``deform_params`` is given.  The JAX PRNG key has no torch
    counterpart: the state's generator is seeded with ``seed``.
    """
    dev = device_rules.resolve(device)
    state, net = from_jax_numpy(gaussian_arrays, deform_params, cfg, device=dev)
    keep = set(state.params()) | ({"offset_model"} if net is not None else set())

    def tensors(tree):
        return {k: tree_map(lambda a: torch.as_tensor(np.array(a, np.float32), device=dev), v)
                for k, v in tree.items() if k in keep}

    step = torch.tensor(int(np.asarray(adam["step"])), dtype=torch.int32, device=dev)
    return TrainState(state, net, AdamState(tensors(adam["mu"]), tensors(adam["nu"]), step),
                      make_generator(seed, dev))


def train_state_to_numpy(ts: TrainState) -> Dict:
    """The port's ``TrainState`` -> ``{"gaussians": {field: array}, "deform":
    net pytree or None, "adam": {"mu", "nu", "step"}}`` in the JAX layout."""

    def np_tree(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    return {
        "gaussians": {f.name: getattr(ts.gaussians, f.name).detach().cpu().numpy()
                      for f in dataclasses.fields(ts.gaussians)},
        "deform": None if ts.net is None else ts.net.numpy_params(),
        "adam": {"mu": np_tree(ts.adam.mu), "nu": np_tree(ts.adam.nu),
                 "step": int(ts.adam.step)},
    }
