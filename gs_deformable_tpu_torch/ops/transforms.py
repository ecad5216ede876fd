"""Camera and covariance math (port of ``gs_deformable_tpu/ops/transforms.py``).

Points transform as row vectors: ``p_cam = [p, 1] @ world_view`` and
``p_clip = [p, 1] @ full_proj``.  Quaternions are (r, x, y, z) and are not
normalized here; the caller's rotation activation does that.
"""

from __future__ import annotations

import numpy as np
import torch


def _rot_entries(q: torch.Tensor):
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)),
        (2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)),
        (2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (r, x, y, z) -> (..., 3, 3) rotation matrix."""
    R = _rot_entries(q)
    return torch.stack([torch.stack(row, dim=-1) for row in R], dim=-2)


def build_cov3d(scaling: torch.Tensor, rotation: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """Sigma = L L^T with L = R diag(s): packed (..., 6) [xx, xy, xz, yy, yz, zz]."""
    R = _rot_entries(rotation)
    s = scale_modifier * scaling
    L = [[R[a][j] * s[..., j] for j in range(3)] for a in range(3)]

    def sig(a, b):
        return L[a][0] * L[b][0] + L[a][1] * L[b][1] + L[a][2] * L[b][2]

    return torch.stack(
        [sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1), sig(1, 2), sig(2, 2)], dim=-1)


def unpack_cov3d(cov6: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed upper triangle, as ``build_cov3d`` packs it -> (..., 3, 3)."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def world_to_view(R: np.ndarray, t: np.ndarray, translate: np.ndarray = np.zeros(3),
                  scale: float = 1.0) -> np.ndarray:
    """getWorld2View2, transposed to the row-vector convention: (4, 4) float32."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W)).T.copy()


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective, transposed to the row-vector convention."""
    top = np.tan(fovy / 2) * znear
    right = np.tan(fovx / 2) * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P).T.copy()


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * np.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * np.arctan(pixels / (2 * focal))


def camera_center_from_view(world_view: np.ndarray) -> np.ndarray:
    """Row 3 of the inverse of the row-vector view matrix: the camera centre."""
    return np.linalg.inv(world_view)[3, :3]
