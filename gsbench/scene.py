"""Cameras, scenes and net weights made from a seed: the inputs of every cell.

Frozen copies, so that a change to the program or to ``chip_smoke.py``
cannot move them:

- ``arc_c2w`` is ``chip_smoke.scene_cameras``: an arc at distance 10 from
  (0, 0, 6), looking at it, so the readers' [-1.3, 1.3]^3 cloud sits 4 in
  front of the camera as in a D-NeRF orbit;
- ``view_arrays`` is ``data.readers`` + ``data.cameras.load_camera``: the
  COLMAP flip, the row-vector view matrix, the OpenGL projection with
  znear 0.01 and zfar 100, the camera centre;
- ``camera_extent`` is ``data.readers.get_nerfpp_norm``'s radius, the
  trainer's spatial learning-rate scale.

Everything on the device is drawn with one ``torch.Generator`` on that
device, in a few large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

SH_C0 = 0.28209479177387814
DNERF_FOVX = 0.6911112070083618  # camera_angle_x of the D-NeRF synthetic scenes
ARC_TARGET = np.array([0.0, 0.0, 6.0])
ARC_RADIUS = 10.0
ARC_HALF_ANGLE = 0.25
ZNEAR, ZFAR = 0.01, 100.0


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def arc_c2w(angle: float, height: float) -> np.ndarray:
    """OpenGL camera-to-world of the arc camera at ``angle`` (rad) raised by ``height``."""
    eye = ARC_TARGET + ARC_RADIUS * np.array([np.sin(angle), height / ARC_RADIUS,
                                              -np.cos(angle)])
    fwd = (ARC_TARGET - eye) / np.linalg.norm(ARC_TARGET - eye)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)  # x right, y down, z fwd
    c2w[:3, 3] = eye
    c2w[:3, 1:3] *= -1  # COLMAP -> OpenGL, undone in view_arrays
    return c2w


def train_views(n: int) -> List[np.ndarray]:
    """``n`` views spread over the arc, at heights in [-0.3, 0.3] that follow
    the golden ratio, the same for every seed (only their order is drawn)."""
    heights = 0.6 * ((np.arange(n) * 0.6180339887498949) % 1.0) - 0.3
    return [arc_c2w(a, h) for a, h in zip(np.linspace(-ARC_HALF_ANGLE, ARC_HALF_ANGLE, n),
                                          heights)]


def fovy_of(fovx: float, width: int, height: int) -> float:
    return 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)


class View(NamedTuple):
    """One camera as numpy arrays in the renderer's row-vector convention."""

    world_view: np.ndarray  # (4, 4)
    full_proj: np.ndarray  # (4, 4)
    center: np.ndarray  # (3,)
    time: float
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float


def _projection(fovx: float, fovy: float) -> np.ndarray:
    top = math.tan(fovy / 2) * ZNEAR
    right = math.tan(fovx / 2) * ZNEAR
    P = np.zeros((4, 4))
    P[0, 0] = ZNEAR / right
    P[1, 1] = ZNEAR / top
    P[3, 2] = 1.0
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return P.T


def view_arrays(c2w: np.ndarray, time: float, width: int, height: int,
                fovx: float = DNERF_FOVX) -> View:
    fovy = fovy_of(fovx, width, height)
    w2c = np.linalg.inv(c2w * np.array([1.0, -1.0, -1.0, 1.0]))
    world_view = np.float32(w2c.T)  # (R^T, t) of the reader, transposed to row vectors
    full_proj = np.float32(world_view.astype(np.float64) @ _projection(fovx, fovy))
    center = np.float32(np.linalg.inv(world_view.astype(np.float64))[3, :3])
    return View(world_view, full_proj, center, float(time), width, height,
                math.tan(fovx / 2), math.tan(fovy / 2))


def camera_extent(c2ws: Sequence[np.ndarray]) -> float:
    centers = np.stack([c[:3, 3] for c in c2ws], 1)
    return float(np.linalg.norm(centers - centers.mean(1, keepdims=True), axis=0).max() * 1.1)


class Cloud(NamedTuple):
    """The alive gaussians' raw attributes, (n, ...) on the device."""

    xyz: torch.Tensor  # (n, 3)
    f_dc: torch.Tensor  # (n, 1, 3)
    f_rest: torch.Tensor  # (n, K - 1, 3)
    opacity: torch.Tensor  # (n, 1) logit
    scaling: torch.Tensor  # (n, 3) log
    rotation: torch.Tensor  # (n, 4)


def cloud(n: int, sh_degree: int, gen: torch.Generator, device) -> Dict[str, Cloud]:
    """The truth and the trained state: one geometry (positions in
    [-1.3, 1.3]^3, scales 0.01 U(0.5, 2) per axis, random unit rotations,
    opacity 0.1, no view-dependent colour) with two independent draws of
    the DC colour.  The state is trained towards images of the truth."""
    K = (sh_degree + 1) ** 2
    u = torch.rand((n, 12), generator=gen, device=device)
    q = torch.randn((n, 4), generator=gen, device=device)
    geom = dict(xyz=u[:, 0:3] * 2.6 - 1.3,
                f_rest=torch.zeros((n, K - 1, 3), device=device),
                opacity=torch.full((n, 1), math.log(0.1 / 0.9), device=device),
                scaling=torch.log(0.01 * (0.5 + 1.5 * u[:, 3:6])),
                rotation=q / torch.linalg.vector_norm(q, dim=-1, keepdim=True))
    return {"truth": Cloud(f_dc=((u[:, 6:9] - 0.5) / SH_C0)[:, None, :], **geom),
            "state": Cloud(f_dc=((u[:, 9:12] - 0.5) / SH_C0)[:, None, :], **geom)}


def mlp_shapes(in_dim: int, skip_dim: int, head_dims: Sequence[int], depth: int, width: int,
               skips: Sequence[int]):
    """(fan_in, fan_out) of each trunk layer and of each head."""
    layers, fan_in = [], in_dim
    for i in range(depth):
        layers.append((fan_in, width))
        fan_in = width + (skip_dim if i in skips else 0)
    return layers, [(width, d) for d in head_dims]


def mlp_weights(shapes, head_scale: float, gen: torch.Generator, device) -> Dict[str, list]:
    """torch.nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weights and biases, drawn in one call; heads scaled by ``head_scale``.
    Weights are (in, out): a layer is ``x @ w + b``."""
    layers, heads = shapes
    total = sum(i * o + o for i, o in layers + heads)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, pos = {"layers": [], "heads": []}, 0
    for key, group, scale in (("layers", layers, 1.0), ("heads", heads, head_scale)):
        for i, o in group:
            bound = scale / math.sqrt(i)
            w = flat[pos:pos + i * o].view(i, o) * bound
            b = flat[pos + i * o:pos + i * o + o] * bound
            pos += i * o + o
            out[key].append({"w": w, "b": b})
    return out
