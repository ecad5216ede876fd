"""Carry a model or a train state between the JAX package and the port.

Everything here takes or returns numpy arrays only (``np.asarray`` of the
JAX leaves), so the port never imports JAX.  The nets keep the JAX
weight orientation: ``w`` is (in, out) and a layer is ``x @ w + b``.  The
deformation net (offset or SE(3), as ``cfg.model.deform_mode`` says) keeps
its Adam moments in the JAX ``{"layers": [{"w", "b"}...], "heads": [...]}``
layout under the ``"offset_model"`` group; the latent heads are the JAX
state's ``latent`` dict (rot, scaling, opacity_mask, shs) and have none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import device as device_rules
from .config import Config
from .models.deform import DeformMLP, OffsetNet, SE3Net, make_latent_heads
from .models.gaussians import AdamState, GaussianState, tree_map
from .training import TrainState, make_generator


def net_from_numpy(params: Optional[dict], cfg: Config, device="cuda") -> Optional[DeformMLP]:
    """The deformation net of ``cfg.model.deform_mode`` holding ``params``
    (the JAX pytree with numpy leaves): ``SE3Net`` under "se3", else
    ``OffsetNet``; None when ``params`` is None."""
    if params is None:
        return None
    cls = SE3Net if cfg.model.deform_mode == "se3" else OffsetNet
    return cls(params, cfg.deform, device=device)


def latent_from_numpy(params: Optional[dict], cfg: Config,
                      device="cuda") -> Optional[Dict[str, DeformMLP]]:
    """The latent heads from the JAX state's ``latent`` dict (numpy leaves)."""
    return None if params is None else make_latent_heads(params, cfg.deform, device=device)


def from_jax_numpy(gaussian_arrays: Dict[str, np.ndarray], deform_params: Optional[dict],
                   cfg: Config, device="cuda") -> Tuple[GaussianState, Optional[DeformMLP]]:
    """(GaussianState, net) from the JAX state's fields and net pytree.

    ``gaussian_arrays`` maps GaussianState field names to arrays;
    ``deform_params`` is the ``{"layers": [{"w", "b"}...], "heads": [...]}``
    pytree with numpy leaves, or None for ``deform_mode="none"``.
    """
    dev = device_rules.resolve(device)
    state = GaussianState.from_numpy(gaussian_arrays, device=dev)
    return state, net_from_numpy(deform_params, cfg, device=dev)


def train_state_from_jax_numpy(gaussian_arrays: Dict[str, np.ndarray],
                               deform_params: Optional[dict], adam: Dict, cfg: Config,
                               device="cuda", seed: int = 0,
                               latent_params: Optional[dict] = None) -> TrainState:
    """A JAX ``TrainState`` as numpy leaves -> the port's ``TrainState``.

    ``adam`` is ``{"mu": {group: array or net subtree}, "nu": {...}, "step":
    int}`` as JAX's ``AdamState``; a ``"offset_model"`` group is kept only
    when ``deform_params`` is given.  ``latent_params`` is the JAX
    ``latent`` dict, or None for a state without latent heads.  The JAX PRNG
    key has no torch counterpart: the state's generator is seeded with
    ``seed``.
    """
    dev = device_rules.resolve(device)
    state, net = from_jax_numpy(gaussian_arrays, deform_params, cfg, device=dev)
    keep = set(state.params()) | ({"offset_model"} if net is not None else set())

    def tensors(tree):
        return {k: tree_map(lambda a: torch.as_tensor(np.array(a, np.float32), device=dev), v)
                for k, v in tree.items() if k in keep}

    step = torch.tensor(int(np.asarray(adam["step"])), dtype=torch.int32, device=dev)
    return TrainState(state, net, AdamState(tensors(adam["mu"]), tensors(adam["nu"]), step),
                      make_generator(seed, dev), latent_from_numpy(latent_params, cfg, dev))


def train_state_to_numpy(ts: TrainState) -> Dict:
    """The port's ``TrainState`` -> ``{"gaussians": {field: array}, "deform":
    net pytree or None, "latent": {head: pytree} or None, "adam": {"mu",
    "nu", "step"}}`` in the JAX layout."""

    def np_tree(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    return {
        "gaussians": {f.name: getattr(ts.gaussians, f.name).detach().cpu().numpy()
                      for f in dataclasses.fields(ts.gaussians)},
        "deform": None if ts.net is None else ts.net.numpy_params(),
        "latent": None if ts.latent is None else {k: m.numpy_params()
                                                  for k, m in ts.latent.items()},
        "adam": {"mu": np_tree(ts.adam.mu), "nu": np_tree(ts.adam.nu),
                 "step": int(ts.adam.step)},
    }
