"""Fixed-capacity gaussian state, Adam and densification statistics.

Port of ``gs_deformable_tpu/models/gaussians.py``: ``GaussianState``
(:42-87), ``AdamState``/``adam_init``/``adam_step`` (:137-185) and
``add_densification_stats`` (:194-207).  Capacity ``P`` rows with an
``alive`` mask; dead slots are inert in the render
(``renderer.deformed_attributes`` routes them to finite constants).

Adam keeps explicit per-group moment tensors (``mu``/``nu`` dicts keyed by
group, the net's as a ``{"layers", "heads"}`` subtree) rather than
``torch.optim.Adam``'s hidden state: densify/prune edits them row by row,
and the tests compare them with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .. import device as device_rules

PARAM_GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
_FIELDS = PARAM_GROUPS + ("alive", "max_radii2d", "xyz_gradient_accum", "denom",
                          "last_offset_norm")


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

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()

    def params(self) -> Dict[str, torch.Tensor]:
        """The six trained groups, keyed by ``PARAM_GROUPS``."""
        return {k: getattr(self, k) for k in PARAM_GROUPS}

    def with_params(self, p: Dict[str, torch.Tensor]) -> "GaussianState":
        return dataclasses.replace(self, **p)

    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    def get_rotation(self) -> torch.Tensor:
        return self.rotation / torch.linalg.vector_norm(self.rotation, dim=-1, keepdim=True)

    def get_features(self) -> torch.Tensor:
        """(P, K, 3): DC then rest."""
        return torch.cat([self.f_dc, self.f_rest], dim=1)


Tree = Any


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching dict/list trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _tree_unzip3(tree):
    """A tree of 3-tuples -> three trees."""
    if isinstance(tree, dict):
        parts = {k: _tree_unzip3(v) for k, v in tree.items()}
        return tuple({k: v[i] for k, v in parts.items()} for i in range(3))
    if isinstance(tree, list):
        parts = [_tree_unzip3(v) for v in tree]
        return tuple([v[i] for v in parts] for i in range(3))
    return tree


@dataclasses.dataclass
class AdamState:
    mu: Dict[str, Tree]
    nu: Dict[str, Tree]
    step: torch.Tensor  # () int32


def adam_init(params: Dict[str, Tree]) -> AdamState:
    """Zero moments shaped like ``params``; step 0 on the params' device."""
    device = tree_leaves(params)[0].device
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     step=torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def adam_step(params: Dict[str, Tree], grads: Dict[str, Tree], opt: AdamState,
              lrs: Dict[str, torch.Tensor], *, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-15) -> Tuple[Dict[str, Tree], AdamState]:
    """One torch-convention Adam step over dicts keyed by group (a group may
    be a subtree sharing its group's learning rate).  The JAX formulas of
    gaussians.py:152-185 in the same order, bias corrections in fp32.
    Returns (new params, new AdamState); nothing is updated in place."""
    step = opt.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        lr = lrs[k]

        def upd(p, g, m, v):
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            return p - lr * mhat / (torch.sqrt(vhat) + eps), m, v

        new_p[k], new_m[k], new_v[k] = _tree_unzip3(
            tree_map(upd, params[k], grads[k], opt.mu[k], opt.nu[k]))
    return new_p, AdamState(mu=new_m, nu=new_v, step=step)


@torch.no_grad()
def add_densification_stats(state: GaussianState, means2d_ndc_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor) -> GaussianState:
    """Accumulate |dL/d ndc mean2D|, the view count and the max screen radius
    of visible alive gaussians (gaussian_model.py:1252-1257, train.py:613-615)."""
    vis = visibility & state.alive
    gn = torch.linalg.vector_norm(means2d_ndc_grad[:, :2], dim=-1, keepdim=True)
    return dataclasses.replace(
        state,
        xyz_gradient_accum=state.xyz_gradient_accum + torch.where(vis[:, None], gn, 0.0),
        denom=state.denom + vis[:, None].to(torch.float32),
        max_radii2d=torch.where(vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
                                state.max_radii2d))
