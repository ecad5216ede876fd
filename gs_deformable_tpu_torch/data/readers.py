"""Scene readers: COLMAP video, Blender/D-NeRF and Nerfies/HyperNeRF.

The port's own copy of ``gs_deformable_tpu/data/readers.py``, with the same
conventions:

- COLMAP: time = int(image_name) / number of cameras; the SfM cloud is
  replaced by ``random_init_points`` uniform points in its bounding box.
- Blender/D-NeRF: time from each frame's ``time`` (default 1.0); RGBA
  composited over the chosen background; random init in [-1.3, 1.3]^3.
- Nerfies/HyperNeRF: scene.json scale and centre applied to cameras and
  points; time = warp_id / max(warp_id); every 4th camera is a test view,
  but all cameras train; the COLMAP or ``points.npy`` cloud gains
  ``random_init_points`` random points in its bounding box.

Random draws come from the ``rng`` argument (a ``np.random.RandomState``;
a fresh ``RandomState(0)`` when it is None), never from numpy's global
state: the same seed gives the JAX package's draws after
``np.random.seed(seed)``.  A reader writes the initial cloud into the scene
directory (``points3d.ply``, or ``sparse/0/points3D.ply`` for COLMAP) the
first time and reads it back from there afterwards.  Images are opened
with Pillow.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
from ..io.ply import fetch_point_cloud, store_point_cloud
from ..ops.sh import C0
from ..ops.transforms import focal2fov, fov2focal
from .cameras import CameraInfo
from .colmap import (
    qvec2rotmat,
    read_extrinsics_binary,
    read_extrinsics_text,
    read_intrinsics_binary,
    read_intrinsics_text,
    read_points3d_binary,
    read_points3d_text,
)


def sh2rgb(sh: np.ndarray) -> np.ndarray:
    """DC coefficient -> RGB, in numpy (float64 for float64 input, as the
    JAX package's ``sh2rgb`` computes on the numpy arrays it is given)."""
    return sh * C0 + 0.5


def _rng(rng: Optional[np.random.RandomState]) -> np.random.RandomState:
    return np.random.RandomState(0) if rng is None else rng


class PointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneInfo(NamedTuple):
    point_cloud: Optional[PointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: Dict[str, np.ndarray]
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> Dict[str, np.ndarray]:
    """getNerfppNorm (dataset_readers.py:47-68): camera-center bounding sphere,
    radius = 1.1 * max distance from the average center."""
    centers = []
    for cam in cam_infos:
        Rt = np.zeros((4, 4))
        Rt[:3, :3] = cam.R.transpose()
        Rt[:3, 3] = cam.T
        Rt[3, 3] = 1.0
        C2W = np.linalg.inv(Rt)
        centers.append(C2W[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=0)
    diagonal = float(dist.max())
    radius = diagonal * 1.1
    return {"translate": -avg[:, 0], "radius": radius}


def _random_bbox_cloud(xyz: np.ndarray, num: int, rng: np.random.RandomState) -> PointCloud:
    """``num`` uniform points in the bounding box of ``xyz`` with random
    near-grey colours."""
    lo = np.min(xyz, axis=0)
    hi = np.max(xyz, axis=0)
    pts = rng.uniform(lo, hi, size=(num, 3))
    shs = rng.random_sample((num, 3)) / 255.0
    return PointCloud(points=pts, colors=sh2rgb(shs), normals=np.zeros((num, 3)))


def read_colmap_scene(
    path: str,
    images: Optional[str] = "images",
    eval: bool = False,
    llffhold: int = 10,
    random_init_points: int = 100_000,
    rng: Optional[np.random.RandomState] = None,
) -> SceneInfo:
    """readColmapSceneInfo (dataset_readers.py:253-312); with ``eval`` every
    ``llffhold``-th frame is a test view."""
    from PIL import Image

    sparse = os.path.join(path, "sparse/0")
    try:
        extr = read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        intr = read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except Exception:
        extr = read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = "images" if images is None else images
    images_folder = os.path.join(path, reading_dir)
    cam_infos = []
    num_cams = len(extr)
    for key in extr:
        e = extr[key]
        i = intr[e.camera_id]
        R = np.transpose(qvec2rotmat(e.qvec))
        T = np.array(e.tvec)
        if i.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(i.params[0], i.height)
            fovx = focal2fov(i.params[0], i.width)
        elif i.model == "PINHOLE":
            fovy = focal2fov(i.params[1], i.height)
            fovx = focal2fov(i.params[0], i.width)
        else:
            raise AssertionError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!"
            )
        image_path = os.path.join(images_folder, os.path.basename(e.name))
        image_name = os.path.basename(image_path).split(".")[0]
        # time = frame index / #cameras — monocular video convention (:106)
        cam_infos.append(
            CameraInfo(
                uid=i.id, R=R, T=T, fovx=fovx, fovy=fovy,
                image=Image.open(image_path), image_path=image_path,
                image_name=image_name, width=i.width, height=i.height,
                time=int(image_name) / num_cams,
            )
        )
    cam_infos = sorted(cam_infos, key=lambda x: x.image_name)

    if eval:
        train = [c for idx, c in enumerate(cam_infos) if idx % llffhold != 0]
        test = [c for idx, c in enumerate(cam_infos) if idx % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, _, _ = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except Exception:
            xyz, _, _ = read_points3d_text(os.path.join(sparse, "points3D.txt"))
        pcd = _random_bbox_cloud(xyz, random_init_points, _rng(rng))
        store_point_cloud(ply_path, pcd.points, pcd.colors * 255)
    pts, cols, normals = fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(pcd, train, test, norm, ply_path)


def _read_transforms(path: str, transformsfile: str, white_background: bool,
                     extension: str = ".png") -> List[CameraInfo]:
    """readCamerasFromTransforms (dataset_readers.py:449-543)."""
    from PIL import Image

    cam_infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender (Y up, Z back) -> COLMAP (Y down, Z forward)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        image = Image.open(cam_name)
        im_data = np.array(image.convert("RGBA"))
        bg = np.array([1, 1, 1]) if white_background else np.array([0, 0, 0])
        norm = im_data / 255.0
        arr = norm[:, :, :3] * norm[:, :, 3:4] + bg * (1 - norm[:, :, 3:4])
        image = Image.fromarray(np.array(arr * 255.0, dtype=np.uint8), "RGB")

        fovy = focal2fov(fov2focal(fovx, image.size[0]), image.size[1])
        cur_time = frame["time"] if "time" in frame else 1.0
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
                image_path=cam_name, image_name=Path(cam_name).stem,
                width=image.size[0], height=image.size[1], time=cur_time,
            )
        )
    return cam_infos


def read_blender_scene(
    path: str,
    white_background: bool = False,
    eval: bool = False,
    extension: str = ".png",
    random_init_points: int = 100_000,
    rng: Optional[np.random.RandomState] = None,
) -> SceneInfo:
    """readNerfSyntheticInfo (dataset_readers.py:545-597): D-NeRF datasets."""
    train = _read_transforms(path, "transforms_train.json", white_background, extension)
    test = _read_transforms(path, "transforms_test.json", white_background, extension)
    if not eval:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # Random init in the synthetic-scene bounds (:577-585).
        rng = _rng(rng)
        xyz = rng.random_sample((random_init_points, 3)) * 2.6 - 1.3
        shs = rng.random_sample((random_init_points, 3)) / 255.0
        store_point_cloud(ply_path, xyz, sh2rgb(shs) * 255)
    pts, cols, normals = fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(pcd, train, test, norm, ply_path)


def _camera_nerfies_from_json(path: str, scale: float) -> dict:
    """camera_nerfies_from_JSON (camera_utils.py:87-120)."""
    with open(path) as f:
        j = json.load(f)
    return {
        "orientation": np.array(j["orientation"]),
        "position": np.array(j["position"]),
        "focal_length": j["focal_length"] * scale,
        "principal_point": np.array(j["principal_point"]) * scale,
        "skew": j["skew"],
        "pixel_aspect_ratio": j["pixel_aspect_ratio"],
        "image_size": np.array([int(round(s * scale)) for s in j["image_size"]]),
    }


def _read_nerfies_cameras(path: str, setname: str):
    """readNerfiesCameras (dataset_readers.py:599-683)."""
    from PIL import Image

    with open(f"{path}/scene.json") as f:
        scene_json = json.load(f)
    with open(f"{path}/metadata.json") as f:
        meta_json = json.load(f)
    with open(f"{path}/dataset.json") as f:
        dataset_json = json.load(f)

    coord_scale = scene_json["scale"]
    scene_center = np.array(scene_json["center"])

    name = path.split("/")[-2] if "/" in path else path
    if name.startswith("interp"):
        all_id = dataset_json["ids"]
        train_img = all_id[::4]
        val_img = all_id[2::4]
        all_img = train_img + val_img
        ratio = 0.5
    else:  # hypernerf: the reference trains on ALL ids (:630-637)
        train_img = dataset_json["ids"] if setname == "train" else dataset_json["val_ids"]
        all_img = train_img
        ratio = 0.5

    train_num = len(train_img)
    all_time = [meta_json[i]["warp_id"] for i in all_img]
    max_time = max(all_time)
    all_time = [meta_json[i]["warp_id"] / max_time for i in all_img]

    all_cam_params = []
    for im in all_img:
        camera = _camera_nerfies_from_json(f"{path}/camera/{im}.json", ratio)
        camera["position"] = (camera["position"] - scene_center) * coord_scale
        all_cam_params.append(camera)
    img_paths = [f"{path}/rgb/{int(1 / ratio)}x/{i}.png" for i in all_img]

    cam_infos = []
    for idx, image_path in enumerate(img_paths):
        image = Image.open(image_path)
        orientation = all_cam_params[idx]["orientation"].T
        position = -all_cam_params[idx]["position"] @ orientation
        focal = all_cam_params[idx]["focal_length"]
        fovy = focal2fov(focal, image.size[1])
        fovx = focal2fov(focal, image.size[0])
        cam_infos.append(
            CameraInfo(
                uid=idx, R=orientation, T=position, fovx=fovx, fovy=fovy,
                image=image, image_path=image_path,
                image_name=Path(image_path).stem,
                width=image.size[0], height=image.size[1], time=all_time[idx],
            )
        )
    return cam_infos, train_num, scene_center, coord_scale


def read_nerfies_scene(
    path: str, eval: bool = False, random_init_points: int = 100_000,
    rng: Optional[np.random.RandomState] = None,
) -> SceneInfo:
    """readNerfiesInfo (dataset_readers.py:685-794)."""
    cam_infos, train_num, scene_center, scene_scale = _read_nerfies_cameras(
        path, setname="train"
    )

    if eval:
        # interp-style 3-in-4 split (:700-715), then overridden: the reference
        # trains on all cameras (:718) — preserved deliberately.
        interval = 4
        all_indices = np.arange(len(cam_infos))
        test_indices = [
            all_indices[i * interval + interval - 1]
            for i in range(len(all_indices) // interval)
        ]
        test = [cam_infos[i] for i in test_indices]
        train = cam_infos
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        npy_path = os.path.join(path, "points.npy")
        if os.path.exists(npy_path):
            xyz = np.load(npy_path)
        else:
            xyz, _, _ = read_points3d_binary(
                os.path.join(path, "colmap/sparse/0/points3D.bin")
            )
        xyz = (xyz - scene_center) * scene_scale
        rng = _rng(rng)
        shs = rng.random_sample((xyz.shape[0], 3)) / 255.0
        extra = _random_bbox_cloud(xyz, random_init_points, rng)
        xyz = np.concatenate([xyz, extra.points], axis=0)
        cols = np.concatenate([sh2rgb(shs), extra.colors], axis=0)
        store_point_cloud(ply_path, xyz, cols * 255)
    pts, cols, normals = fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=cols, normals=normals)
    return SceneInfo(pcd, train, test, norm, ply_path)


# Dataset-type sniffing (scene/__init__.py:43-54 + callback table :797-803).
scene_load_callbacks: Dict[str, Callable[..., SceneInfo]] = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "nerfies": read_nerfies_scene,
}


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    if os.path.exists(os.path.join(path, "metadata.json")):
        return "nerfies"
    raise ValueError(f"Could not recognize scene type for {path}")
