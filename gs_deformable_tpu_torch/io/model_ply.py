"""Save and load a trained model (port of ``io/model_ply.py``).

PLY schema: x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..(3(K-1)-1),opacity,
scale_0..2,rot_0..3 with channel-major features.  The nets sit beside the
PLY as ``<name>.npz`` with keys like ``['layers']/[0]/['w']`` (the JAX
pytree paths), so a file written by either package loads in the other:
``offset_model`` (the offset or SE(3) net), then the latent heads
``offset_model_rot``, ``offset_model_scaling``, ``opacity_mask`` and
``shs_model``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, Optional, Tuple, Type

import numpy as np
import torch

from .. import device as device_rules
from ..config import DeformConfig
from ..models.deform import DeformMLP, OffsetNet, SE3Net
from ..models.gaussians import GaussianState
from .ply import read_ply, write_ply

NET_FILES = ("offset_model", "offset_model_rot", "offset_model_scaling", "opacity_mask",
             "shs_model")
# The latent head each file after "offset_model" holds (render_cli.py:146-151).
LATENT_FILES = {"rot": "offset_model_rot", "scaling": "offset_model_scaling",
                "opacity_mask": "opacity_mask", "shs": "shs_model"}


def nets_dict(net: Optional[DeformMLP], latent: Optional[Dict[str, DeformMLP]]) -> dict:
    """``save_ply``'s ``nets``: the deformation net as "offset_model" and each
    latent head under its file name (train.py:420-427 of the JAX package)."""
    nets = {"offset_model": None if net is None else net.param_tree()}
    for key, name in LATENT_FILES.items():
        nets[name] = None if latent is None else latent[key].param_tree()
    return nets


def map_tree(tree: Any, fn: Callable[[str, Any], Any], prefix: str = "") -> Any:
    """``fn(key, leaf)`` over the leaves of a dict/list tree, ``key`` the JAX
    path string: ``['name']`` for a dict key, ``[i]`` for a list index,
    joined by ``/`` after ``prefix``."""
    sep = "/" if prefix else ""
    if isinstance(tree, dict):
        return {k: map_tree(v, fn, f"{prefix}{sep}['{k}']") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_tree(v, fn, f"{prefix}{sep}[{i}]") for i, v in enumerate(tree)]
    return fn(prefix, tree)


def to_numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_net(path: str, params: Any) -> None:
    """A net's ``{"layers", "heads"}`` tree (tensors or arrays) as an .npz."""
    flat = {}
    map_tree(params, lambda k, v: flat.__setitem__(k, to_numpy(v)))
    np.savez(path, **flat)


def save_ply(directory: str, state: GaussianState, nets: Optional[Dict[str, Any]] = None, *,
             xyz_override: Optional[torch.Tensor] = None,
             filename: str = "point_cloud.ply") -> str:
    """The alive rows of ``state`` as ``directory/filename`` and each net of
    ``nets`` named in ``NET_FILES`` as ``directory/<name>.npz``; returns the
    PLY's path.  ``xyz_override`` replaces the means (a deformed frame)."""
    os.makedirs(directory, exist_ok=True)
    alive = to_numpy(state.alive)
    xyz = to_numpy(state.xyz if xyz_override is None else xyz_override)[alive]
    n = xyz.shape[0]
    # channel-major: (N, K, 3) -> (N, 3, K) -> (N, 3K)
    dc = np.transpose(to_numpy(state.f_dc)[alive], (0, 2, 1)).reshape(n, -1)
    rest = np.transpose(to_numpy(state.f_rest)[alive], (0, 2, 1)).reshape(n, -1)
    opacity = to_numpy(state.opacity)[alive]
    scaling = to_numpy(state.scaling)[alive]
    rotation = to_numpy(state.rotation)[alive]

    names = ["x", "y", "z", "nx", "ny", "nz"]
    cols = [xyz[:, 0], xyz[:, 1], xyz[:, 2]] + [np.zeros(n, np.float32)] * 3
    for prefix, block in (("f_dc", dc), ("f_rest", rest)):
        names += [f"{prefix}_{i}" for i in range(block.shape[1])]
        cols += [block[:, i] for i in range(block.shape[1])]
    names.append("opacity")
    cols.append(opacity[:, 0])
    for prefix, block in (("scale", scaling), ("rot", rotation)):
        names += [f"{prefix}_{i}" for i in range(block.shape[1])]
        cols += [block[:, i] for i in range(block.shape[1])]

    path = os.path.join(directory, filename)
    write_ply(path, names, [np.ascontiguousarray(c, np.float32) for c in cols])
    for name in NET_FILES:
        if nets and nets.get(name) is not None:
            save_net(os.path.join(directory, f"{name}.npz"), nets[name])
    return path

def _sorted_names(d, prefix):
    return sorted((k for k in d if k.startswith(prefix)), key=lambda s: int(s.split("_")[-1]))


def load_ply(path: str, capacity: int, sh_degree: int,
             device="cuda") -> Tuple[GaussianState, int]:
    """PLY -> (fixed-capacity GaussianState, active_sh_degree = sh_degree)."""
    dev = device_rules.resolve(device)
    d = read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    n = xyz.shape[0]
    K = (sh_degree + 1) ** 2
    dc_names = _sorted_names(d, "f_dc_")
    rest_names = _sorted_names(d, "f_rest_")
    if len(rest_names) != 3 * (K - 1):
        raise ValueError(f"{path}: {len(rest_names)} f_rest properties, "
                         f"SH degree {sh_degree} needs {3 * (K - 1)}")
    if n > capacity:
        raise ValueError(f"{n} gaussians exceed capacity {capacity}")
    dc = np.stack([d[k] for k in dc_names], -1).reshape(n, 3, 1)
    rest = (np.stack([d[k] for k in rest_names], -1).reshape(n, 3, K - 1)
            if rest_names else np.zeros((n, 3, 0), np.float32))
    scaling = np.stack([d[k] for k in _sorted_names(d, "scale_")], -1).astype(np.float32)
    rotation = np.stack([d[k] for k in _sorted_names(d, "rot_")], -1).astype(np.float32)

    def pad(x):
        return np.pad(x, [(0, capacity - n)] + [(0, 0)] * (x.ndim - 1))

    rot_pad = pad(rotation)
    rot_pad[n:, 0] = 1.0  # dead slots: identity quaternions
    arrays = {
        "xyz": pad(xyz),
        "f_dc": pad(np.transpose(dc, (0, 2, 1))),
        "f_rest": pad(np.transpose(rest, (0, 2, 1))),
        "opacity": pad(d["opacity"].reshape(n, 1).astype(np.float32)),
        "scaling": pad(scaling),
        "rotation": rot_pad,
        "alive": pad(np.ones(n, bool)),
    }
    return GaussianState.from_numpy(arrays, device=dev), sh_degree


_KEY = re.compile(r"\['(layers|heads)'\]/\[(\d+)\]/\['(w|b)'\]")


def load_net_params(path: str) -> dict:
    """A saved net (.npz) as the numpy pytree ``{"layers", "heads"}``."""
    tree = {"layers": {}, "heads": {}}
    with np.load(path) as data:
        for key in data.files:
            m = _KEY.fullmatch(key)
            if m is None:
                raise ValueError(f"{path}: unexpected key {key!r}")
            group, idx, leaf = m.group(1), int(m.group(2)), m.group(3)
            tree[group].setdefault(idx, {})[leaf] = np.asarray(data[key])
    return {g: [tree[g][i] for i in sorted(tree[g])] for g in ("layers", "heads")}


def load_net(path: str, cfg: DeformConfig = DeformConfig(), device="cuda", *,
             kind: Type[DeformMLP]) -> DeformMLP:
    """A saved net (.npz written by either package) as the class ``kind``:
    ``OffsetNet``, ``SE3Net``, or ``DeformMLP`` for a latent head (without
    gradient)."""
    net = kind(load_net_params(path), cfg, device=device_rules.resolve(device))
    return net if kind in (OffsetNet, SE3Net) else net.requires_grad_(False)


def load_latent(directory: str, latent: Dict[str, DeformMLP],
                device="cuda") -> Tuple[Dict[str, DeformMLP], int]:
    """``latent`` with each head whose file exists in ``directory`` replaced
    by the file's weights; (heads, the number of files read)."""
    out, n = dict(latent), 0
    for key, name in LATENT_FILES.items():
        path = os.path.join(directory, f"{name}.npz")
        if os.path.exists(path):
            out[key] = load_net(path, latent[key].cfg, device, kind=DeformMLP)
            n += 1
    return out, n
