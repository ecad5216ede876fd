"""Fixed-capacity gaussian state, Adam, densification statistics and
densify/prune.

Port of ``gs_deformable_tpu/models/gaussians.py``: ``GaussianState``
(:42-87), ``init_from_points`` (:90), ``AdamState``/``adam_init``/
``adam_step`` (:137-185), ``add_densification_stats`` (:194-207),
``DensifyInfo``/``densify_and_prune`` (:215-355) and ``reset_opacity``
(:358).  Capacity ``P`` rows with an ``alive`` mask; dead slots are inert
in the render (``renderer.deformed_attributes`` routes them to finite
constants).  Densification writes clones and split children into free
slots and pruning clears ``alive`` bits, so no tensor changes shape.

Adam keeps explicit per-group moment tensors (``mu``/``nu`` dicts keyed by
group, the net's as a ``{"layers", "heads"}`` subtree) rather than
``torch.optim.Adam``'s hidden state: densify/prune edits them row by row,
and the tests compare them with the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import device as device_rules
from .. import tracing
from ..ops import knn as knn_ops
from ..ops.sh import rgb2sh
from ..ops.transforms import quat_to_rotmat
from ..utils.general import inverse_sigmoid

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


def init_from_points(points: np.ndarray, colors: np.ndarray, capacity: int, sh_degree: int,
                     device="cuda") -> GaussianState:
    """A fixed-capacity state from a point cloud: ``log(sqrt(max(knn3, 1e-7)))``
    on every scale axis (``ops.knn.mean_sq_dist_knn3``), identity
    quaternions, opacity ``inverse_sigmoid(0.1)``, the DC colour from
    ``colors`` in [0, 1], zero higher SH; rows past ``len(points)`` dead.
    ``device`` defaults to ``"cuda"`` and raises without a GPU."""
    dev = device_rules.resolve(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points exceed capacity {capacity}")
    K = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    dist2 = torch.clamp(knn_ops.mean_sq_dist_knn3(pts), min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        return torch.cat([x, x.new_full((capacity - n,) + x.shape[1:], fill)])

    f_dc = rgb2sh(torch.as_tensor(np.asarray(colors, np.float32), device=dev))[:, None, :]
    rotation = torch.zeros((capacity, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0  # dead slots too, so activations stay finite
    zeros = torch.zeros(capacity, dtype=torch.float32, device=dev)
    return GaussianState(
        xyz=pad(pts), f_dc=pad(f_dc),
        f_rest=torch.zeros((capacity, K - 1, 3), dtype=torch.float32, device=dev),
        opacity=pad(inverse_sigmoid(torch.full((n, 1), 0.1, device=dev))),
        scaling=pad(scales), rotation=rotation,
        alive=pad(torch.ones(n, dtype=torch.bool, device=dev), False),
        max_radii2d=zeros, xyz_gradient_accum=zeros[:, None].clone(),
        denom=zeros[:, None].clone(), last_offset_norm=zeros.clone())


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
    with tracing.span("gs.optimizer"):
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
def _densification_increments(state: GaussianState, means2d_ndc_grad: torch.Tensor,
                              visibility: torch.Tensor, radii: torch.Tensor):
    """One camera's (|dL/d ndc mean2D|, view count, max screen radius) of the
    visible alive rows; 0, 0 and the old radius elsewhere."""
    vis = visibility & state.alive
    gn = torch.linalg.vector_norm(means2d_ndc_grad[:, :2], dim=-1, keepdim=True)
    return (torch.where(vis[:, None], gn, 0.0), vis[:, None].to(torch.float32),
            torch.where(vis, torch.maximum(state.max_radii2d, radii.to(torch.float32)),
                        state.max_radii2d))


@torch.no_grad()
def add_densification_stats(state: GaussianState, means2d_ndc_grad: torch.Tensor,
                            visibility: torch.Tensor, radii: torch.Tensor) -> GaussianState:
    """Accumulate |dL/d ndc mean2D|, the view count and the max screen radius
    of visible alive gaussians (gaussian_model.py:1252-1257, train.py:613-615)."""
    with tracing.span("gs.optimizer"):
        gn, seen, radii = _densification_increments(state, means2d_ndc_grad, visibility, radii)
        return dataclasses.replace(state, xyz_gradient_accum=state.xyz_gradient_accum + gn,
                                   denom=state.denom + seen, max_radii2d=radii)


class DensifyInfo(NamedTuple):
    """0-d int64 tensors on the state's device."""

    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # clones and children that found no free slot
    n_alive: torch.Tensor


def _scatter_rows(leaf: torch.Tensor, dests, values) -> torch.Tensor:
    """``leaf`` with ``values[i]`` written to row ``dest[i]`` for each
    (dest, values) pair in order; rows sent to ``dest == capacity`` drop.

    The drop goes to a sink row past the end that is sliced off: an
    out-of-range index on a CUDA tensor is a device-side assert.
    """
    out = torch.cat([leaf, leaf.new_zeros((1,) + leaf.shape[1:])])
    for dest, vals in zip(dests, values):
        out.index_copy_(0, dest, vals)
    return out[:leaf.shape[0]]


@torch.no_grad()
def densify_and_prune(state: GaussianState, mu: Dict[str, torch.Tensor],
                      nu: Dict[str, torch.Tensor], normals: torch.Tensor, *,
                      grad_threshold, min_opacity, extent, percent_dense: float,
                      use_screen_prune: bool, offset_mask: Optional[torch.Tensor] = None):
    """Clone, split and prune with fixed shapes (gaussian_model.py:1219-1233).

    Alive rows whose mean |dL/d ndc mean2D| reaches ``grad_threshold``
    clone when their largest scale is at most ``percent_dense * extent``,
    else split into two children drawn at ``xyz + R (normals * scale)``
    with scale / 1.6 (the parent dies).  ``normals`` is the (P, 2, 3)
    standard normal draw of the children's offsets.  Clones take the free
    slots first, in row order, then each split's two children; what does
    not fit drops (``n_dropped``).  New rows get zeroed moments in ``mu``
    and ``nu`` (dicts of the six groups); then rows with opacity below
    ``min_opacity`` (and, with ``use_screen_prune``, a scale above
    ``0.1 * extent``) die, and the densification statistics reset.  The
    reference's screen-size term never fires (it zeroes the screen radii
    before that test), so there is none here.  ``offset_mask``
    (P,) bool, when given, further limits clone and split to its rows.

    Returns (state, mu, nu, DensifyInfo); nothing is updated in place.
    """
    cap = state.capacity
    dev = state.xyz.device
    alive = state.alive
    grads = state.xyz_gradient_accum / state.denom  # NaN where denom = 0
    grads = torch.nan_to_num(torch.where(alive[:, None], grads, 0.0), nan=0.0)[:, 0]

    act_scaling = torch.exp(state.scaling)
    max_scale = act_scaling.max(dim=1).values
    grad_ok = grads >= grad_threshold
    if offset_mask is not None:
        grad_ok = grad_ok & offset_mask
    clone_mask = grad_ok & (max_scale <= percent_dense * extent) & alive
    split_mask = grad_ok & (max_scale > percent_dense * extent) & alive

    # free_idx[r]: the r-th dead row, then cap (jnp.nonzero(~alive, size=cap,
    # fill_value=cap)); the cumsum rank keeps it on the device.
    dead = ~alive
    free_count = dead.sum()
    free_rank = torch.where(dead, torch.cumsum(dead, 0) - 1, cap)
    free_idx = torch.full((cap + 1,), cap, dtype=torch.int64, device=dev)
    free_idx.index_put_((free_rank,), torch.arange(cap, device=dev))
    free_idx = free_idx[:cap]

    def dest(mask, pos):
        d = torch.where(mask, free_idx[pos.clamp(0, cap - 1)], cap)
        return torch.where(pos >= cap, cap, d)

    n_clone = clone_mask.sum()
    dest_c = dest(clone_mask, torch.cumsum(clone_mask, 0) - 1)
    pos_s0 = n_clone + 2 * (torch.cumsum(split_mask, 0) - 1)
    dest_s0 = dest(split_mask, pos_s0)
    dest_s1 = dest(split_mask, pos_s0 + 1)

    n_split = split_mask.sum()
    n_dropped = torch.clamp(n_clone + 2 * n_split - free_count, min=0)

    samples = normals * act_scaling[:, None, :]
    rotn = state.rotation / torch.linalg.vector_norm(state.rotation, dim=-1, keepdim=True)
    offsets = torch.einsum("pij,pnj->pni", quat_to_rotmat(rotn), samples)
    child_xyz = state.xyz[:, None, :] + offsets
    child_scaling = torch.log(act_scaling / (0.8 * 2))

    dests = (dest_c, dest_s0, dest_s1)
    params = state.params()
    new_params, new_mu, new_nu = {}, dict(mu), dict(nu)
    for k in PARAM_GROUPS:
        leaf = params[k]
        if k == "xyz":
            children = (child_xyz[:, 0], child_xyz[:, 1])
        elif k == "scaling":
            children = (child_scaling, child_scaling)
        else:
            children = (leaf, leaf)
        new_params[k] = _scatter_rows(leaf, dests, (leaf,) + children)
        zeros = torch.zeros_like(mu[k])
        new_mu[k] = _scatter_rows(mu[k], dests, (zeros,) * 3)
        new_nu[k] = _scatter_rows(nu[k], dests, (zeros,) * 3)

    ones = torch.ones(cap, dtype=torch.bool, device=dev)
    alive = _scatter_rows(alive, dests, (ones,) * 3) & ~split_mask

    prune = torch.sigmoid(new_params["opacity"][:, 0]) < min_opacity
    if use_screen_prune:
        prune = prune | (torch.exp(new_params["scaling"]).max(dim=1).values > 0.1 * extent)
    n_pruned = (prune & alive).sum()
    alive = alive & ~prune

    new_state = dataclasses.replace(
        state.with_params(new_params), alive=alive,
        max_radii2d=torch.zeros_like(state.max_radii2d),
        xyz_gradient_accum=torch.zeros_like(state.xyz_gradient_accum),
        denom=torch.zeros_like(state.denom),
        last_offset_norm=torch.zeros_like(state.last_offset_norm))
    info = DensifyInfo(n_cloned=n_clone - torch.clamp(n_clone - free_count, min=0),
                       n_split=n_split, n_pruned=n_pruned, n_dropped=n_dropped,
                       n_alive=alive.sum())
    return new_state, new_mu, new_nu, info


@torch.no_grad()
def reset_opacity(state: GaussianState, mu: Dict[str, torch.Tensor],
                  nu: Dict[str, torch.Tensor]):
    """Clamp the activated opacity to at most 0.01 and zero the opacity
    moments (gaussian_model.py:960-963).  Returns (state, mu, nu)."""
    new_op = inverse_sigmoid(torch.clamp(torch.sigmoid(state.opacity), max=0.01))
    mu = dict(mu, opacity=torch.zeros_like(mu["opacity"]))
    nu = dict(nu, opacity=torch.zeros_like(nu["opacity"]))
    return dataclasses.replace(state, opacity=new_op), mu, nu
