"""Camera records: the readers' ``CameraInfo`` and the ready ``Camera``.

The port's own copy of ``gs_deformable_tpu/data/cameras.py``.  A ``Camera``
holds numpy arrays (row-vector view and projection matrices, the ground
truth as float32 (3, H, W) in [0, 1]); ``camera_arrays`` moves one onto a
device as the renderer's ``CameraArrays``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np

from ..ops import transforms as tf
from ..renderer import CameraArrays


class CameraInfo(NamedTuple):
    """One frame as a reader returns it."""

    uid: int
    R: np.ndarray
    T: np.ndarray
    fovx: float
    fovy: float
    image: "object"  # PIL image, decoded by load_camera; None for a camera with no image
    image_path: str
    image_name: str
    width: int
    height: int
    time: float


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    image_name: str
    width: int
    height: int
    fovx: float
    fovy: float
    time: float
    world_view: np.ndarray  # (4, 4) row-vector convention
    full_proj: np.ndarray  # (4, 4)
    camera_center: np.ndarray  # (3,)
    image: Optional[np.ndarray]  # (3, H, W) float32 in [0, 1], or None
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def tan_fovx(self) -> float:
        return float(np.tan(self.fovx * 0.5))

    @property
    def tan_fovy(self) -> float:
        return float(np.tan(self.fovy * 0.5))


def _resolve_resolution(width: int, height: int, resolution: int, scale: float):
    """Output size: -1 scales images wider than 1600 px down to 1600 px;
    1, 2, 4, 8 divide; any other value is a target width."""
    if resolution in (1, 2, 4, 8):
        return round(width / (scale * resolution)), round(height / (scale * resolution))
    if resolution == -1:
        global_down = 1
        if width > 1600:
            warnings.warn("input images wider than 1600 px are rescaled to 1600 px; pass "
                          "resolution=1 to keep them", stacklevel=3)
            global_down = width / 1600
    else:
        global_down = width / resolution
    s = global_down * scale
    return int(width / s), int(height / s)


def load_camera(info: CameraInfo, uid: int, resolution: int = -1,
                resolution_scale: float = 1.0, znear: float = 0.01,
                zfar: float = 100.0) -> Camera:
    """Resize the image with PIL, make it float32 (3, H, W) in [0, 1] with
    the alpha channel (if any) multiplied in, and build the row-vector
    view and projection matrices."""
    w, h = _resolve_resolution(info.width, info.height, resolution, resolution_scale)
    arr = None
    if info.image is not None:
        data = np.asarray(info.image.resize((w, h)), dtype=np.float32) / 255.0
        if data.ndim == 2:
            data = data[:, :, None].repeat(3, axis=2)
        rgb = np.clip(data[:, :, :3], 0.0, 1.0)
        if data.shape[2] == 4:
            rgb = rgb * data[:, :, 3:4]
        arr = np.transpose(rgb, (2, 0, 1)).copy()

    world_view = tf.world_to_view(info.R, info.T)
    full_proj = world_view @ tf.projection_matrix(znear, zfar, info.fovx, info.fovy)
    center = tf.camera_center_from_view(world_view)
    return Camera(uid=uid, colmap_id=info.uid, image_name=info.image_name, width=w, height=h,
                  fovx=info.fovx, fovy=info.fovy, time=float(info.time),
                  world_view=world_view.astype(np.float32),
                  full_proj=full_proj.astype(np.float32),
                  camera_center=center.astype(np.float32), image=arr, znear=znear, zfar=zfar)


def camera_to_json(uid: int, cam: CameraInfo) -> dict:
    """The ``cameras.json`` record of one camera: centre, camera-to-world
    rotation and focal lengths in pixels."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = cam.R.transpose()
    Rt[:3, 3] = cam.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": uid,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": tf.fov2focal(cam.fovy, cam.height),
        "fx": tf.fov2focal(cam.fovx, cam.width),
    }


def camera_arrays(cam: Camera, device="cuda") -> CameraArrays:
    """``cam``'s matrices, centre and time as the renderer's ``CameraArrays``
    on ``device`` (default ``"cuda"``; raises without a GPU)."""
    return CameraArrays.from_numpy(cam.world_view, cam.full_proj, cam.camera_center,
                                   cam.time, device=device)
