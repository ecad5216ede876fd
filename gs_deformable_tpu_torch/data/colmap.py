"""COLMAP model parsing (binary and text), numpy and the standard library.

The port's own copy of ``gs_deformable_tpu/data/colmap.py`` (wire formats of
the reference's colmap_loader.py:83-294).  The three binary readers go
through the port's native C++ reader (``io/native.py``,
``csrc/colmap_io.cpp``) when it is available, and parse in Python when it
is not or when its read fails (``None``), as the JAX package does.
"""

from __future__ import annotations

import struct
from typing import Dict, NamedTuple

import numpy as np


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


# (model_id -> (name, num_params)) — colmap_loader.py:24-40
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """(colmap_loader.py:43-54) — (w, x, y, z) quaternion to rotation matrix."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x**2 - 2 * y**2],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """(colmap_loader.py:56-66)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def read_points3d_binary(path: str):
    """points3D.bin -> (xyz (N,3), rgb (N,3), errors (N,1))
    (colmap_loader.py:101-131); the native reader when available."""
    from ..io import native

    if native.available():
        res = native.read_points3d_bin(path)
        if res is not None:
            return res
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty((n, 1))
        for i in range(n):
            rec = struct.unpack("<QdddBBBd", f.read(43))
            xyz[i] = rec[1:4]
            rgb[i] = rec[4:7]
            err[i] = rec[7]
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_points3d_text(path: str):
    """points3D.txt (colmap_loader.py:69-99)."""
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyz.append([float(v) for v in e[1:4]])
            rgb.append([float(v) for v in e[4:7]])
            err.append([float(e[7])])
    return np.array(xyz), np.array(rgb), np.array(err)


def read_intrinsics_binary(path: str) -> Dict[int, ColmapCamera]:
    """cameras.bin (colmap_loader.py:221-245); the native reader when available."""
    from ..io import native

    if native.available():
        res = native.read_cameras_bin(path)
        if res is not None:
            return {c["id"]: ColmapCamera(id=c["id"], model=CAMERA_MODELS[c["model_id"]][0],
                                          width=c["width"], height=c["height"],
                                          params=c["params"][:CAMERA_MODELS[c["model_id"]][1]])
                    for c in res}
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, num_params = CAMERA_MODELS[mid]
            params = np.array(struct.unpack("<" + "d" * num_params, f.read(8 * num_params)))
            cams[cid] = ColmapCamera(id=cid, model=name, width=w, height=h, params=params)
    return cams


def read_intrinsics_text(path: str) -> Dict[int, ColmapCamera]:
    """cameras.txt (colmap_loader.py:156-184)."""
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cid = int(e[0])
            cams[cid] = ColmapCamera(
                id=cid, model=e[1], width=int(e[2]), height=int(e[3]),
                params=np.array([float(v) for v in e[4:]]),
            )
    return cams


def read_extrinsics_binary(path: str) -> Dict[int, ColmapImage]:
    """images.bin (colmap_loader.py:186-219).  The native reader, when
    available, skips the 2D tracks (nothing downstream reads them): ``xys``
    (0, 2) and ``point3d_ids`` (0,) int64; the Python parser reads them."""
    from ..io import native

    if native.available():
        res = native.read_images_bin(path)
        if res is not None:
            return {im["id"]: ColmapImage(id=im["id"], qvec=im["qvec"], tvec=im["tvec"],
                                          camera_id=im["camera_id"], name=im["name"],
                                          xys=np.empty((0, 2)),
                                          point3d_ids=np.empty(0, np.int64))
                    for im in res}
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            rec = struct.unpack("<idddddddi", f.read(64))
            image_id = rec[0]
            qvec = np.array(rec[1:5])
            tvec = np.array(rec[5:8])
            camera_id = rec[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                if not c:  # the JAX parser loops forever here
                    raise EOFError(f"{path} ends inside an image name")
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            rec_t = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            data = np.frombuffer(f.read(24 * n2d), dtype=rec_t)
            xys = np.stack([data["x"], data["y"]], -1) if n2d else np.empty((0, 2))
            ids = data["id"].copy() if n2d else np.empty(0, np.int64)
            images[image_id] = ColmapImage(
                id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                name=name.decode("utf-8"), xys=xys, point3d_ids=ids,
            )
    return images


def read_extrinsics_text(path: str) -> Dict[int, ColmapImage]:
    """images.txt (colmap_loader.py:246-270)."""
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.lstrip().startswith("#")]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        image_id = int(e[0])
        qvec = np.array([float(v) for v in e[1:5]])
        tvec = np.array([float(v) for v in e[5:8]])
        camera_id = int(e[8])
        name = e[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        if pts:
            arr = np.array([float(v) for v in pts]).reshape(-1, 3)
            xys = arr[:, :2]
            ids = arr[:, 2].astype(np.int64)
        else:
            xys = np.empty((0, 2))
            ids = np.empty(0, np.int64)
        images[image_id] = ColmapImage(
            id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id, name=name,
            xys=xys, point3d_ids=ids,
        )
    return images
