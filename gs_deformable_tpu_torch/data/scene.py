"""Scene container: dataset detection, camera lists, the model directory's
first-run files.

The port's own copy of ``gs_deformable_tpu/data/scene.py``.  Cameras are
host records (``data/cameras.Camera``); the caller builds the gaussian
state from ``scene_info.point_cloud`` (``models/gaussians.init_from_points``).
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import Dict, List, Optional

import numpy as np

from .cameras import Camera, camera_to_json, load_camera
from .readers import SceneInfo, detect_scene_type, scene_load_callbacks


class Scene:
    """Reads ``source_path`` and loads its train and test cameras.

    ``rng`` feeds the reader's random initial cloud and ``shuffle_rng``
    shuffles the camera lists; each defaults to a fresh generator seeded
    with 0.  With a ``model_path`` the scene writes ``input.ply`` (the
    initial cloud) and ``cameras.json`` there.
    """

    def __init__(
        self,
        source_path: str,
        model_path: str,
        images: str = "images",
        eval: bool = False,
        white_background: bool = False,
        shuffle: bool = True,
        resolution: int = -1,
        resolution_scales: List[float] = (1.0,),
        random_init_points: int = 100_000,
        rng: Optional[np.random.RandomState] = None,
        shuffle_rng: Optional[random.Random] = None,
    ):
        self.model_path = model_path
        self.train_cameras: Dict[float, List[Camera]] = {}
        self.test_cameras: Dict[float, List[Camera]] = {}

        kind = detect_scene_type(source_path)
        read = scene_load_callbacks[kind]
        if kind == "Colmap":
            info: SceneInfo = read(source_path, images, eval,
                                   random_init_points=random_init_points, rng=rng)
        elif kind == "Blender":
            print("Found transforms_train.json file, assuming Blender data set!")
            info = read(source_path, white_background, eval,
                        random_init_points=random_init_points, rng=rng)
        else:
            print("Found metadata.json, assuming Nerfies data set!")
            info = read(source_path, eval, random_init_points=random_init_points, rng=rng)
        self.scene_info = info

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            if os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path, os.path.join(model_path, "input.ply"))
            cam_json = [camera_to_json(idx, cam)
                        for idx, cam in enumerate(info.test_cameras + info.train_cameras)]
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        train_list = list(info.train_cameras)
        test_list = list(info.test_cameras)
        if shuffle:
            shuffle_rng = random.Random(0) if shuffle_rng is None else shuffle_rng
            shuffle_rng.shuffle(train_list)
            shuffle_rng.shuffle(test_list)

        self.cameras_extent = float(info.nerf_normalization["radius"])

        for scale in resolution_scales:
            print(f"Loading Training Cameras (scale {scale})")
            self.train_cameras[scale] = [
                load_camera(c, i, resolution, scale) for i, c in enumerate(train_list)]
            print(f"Loading Test Cameras (scale {scale})")
            self.test_cameras[scale] = [
                load_camera(c, i, resolution, scale) for i, c in enumerate(test_list)]

    def get_train_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> List[Camera]:
        return self.test_cameras[scale]

    def point_cloud_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, f"point_cloud/iteration_{iteration}")
