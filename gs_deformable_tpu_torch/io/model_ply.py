"""Load a trained model saved by the JAX package (port of ``io/model_ply.py``).

PLY schema: x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..(3(K-1)-1),opacity,
scale_0..2,rot_0..3 with channel-major features.  The nets sit beside the
PLY as ``<name>.npz`` with keys like ``['layers']/[0]/['w']`` (the JAX
pytree paths).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from .. import device as device_rules
from ..config import DeformConfig
from ..models.deform import OffsetNet
from ..models.gaussians import GaussianState
from .ply import read_ply

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
    """A saved offset net (.npz) as the numpy pytree ``{"layers", "heads"}``."""
    tree = {"layers": {}, "heads": {}}
    with np.load(path) as data:
        for key in data.files:
            m = _KEY.fullmatch(key)
            if m is None:
                raise ValueError(f"{path}: unexpected key {key!r}")
            group, idx, leaf = m.group(1), int(m.group(2)), m.group(3)
            tree[group].setdefault(idx, {})[leaf] = np.asarray(data[key])
    return {g: [tree[g][i] for i in sorted(tree[g])] for g in ("layers", "heads")}


def load_net(path: str, cfg: DeformConfig = DeformConfig(), device="cuda") -> OffsetNet:
    """A saved offset net (.npz written by the JAX package) as an ``OffsetNet``."""
    dev = device_rules.resolve(device)
    return OffsetNet(load_net_params(path), cfg, device=dev)
