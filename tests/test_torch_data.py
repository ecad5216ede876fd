"""Port parity: the data stack (COLMAP parsers, cameras, readers, Scene).

Each scene is written by the test (COLMAP binary through the writers of
tests/test_colmap.py, COLMAP text and Nerfies through tests/test_readers.py,
Blender/D-NeRF through tests/synthetic_scene.py) and copied once per
package: a reader writes its random initial cloud into the scene directory
and reads it back from there, so one copy per package keeps each from
reading the other's cloud.  The JAX package draws from numpy's and
Python's global generators, seeded just before its call; the port gets
``np.random.RandomState(seed)`` and ``random.Random(seed)``, which give the
same streams.  Every camera field, ground-truth image, cloud, normalisation
and written file must be bitwise equal.  Both packages' COLMAP parsers
are held to their Python path (the native readers skip the 2D tracks;
tests/test_torch_native.py holds them to the Python parsers).
"""

import os
import pathlib
import random
import shutil

import numpy as np
import pytest
from PIL import Image

from gs_deformable_tpu.data import cameras as jcameras
from gs_deformable_tpu.data import colmap as jcolmap
from gs_deformable_tpu.data import readers as jreaders
from gs_deformable_tpu.data import scene as jscene
from gs_deformable_tpu.io import native
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu_torch.data import cameras, colmap, readers, scene
from gs_deformable_tpu_torch.io import native as tnative
from gs_deformable_tpu_torch.ops import transforms as tf

from synthetic_scene import build_blender_scene
from test_colmap import write_cameras_bin, write_images_bin, write_points3d_bin
from test_readers import build_colmap_scene, build_nerfies_scene

SEED = 7


@pytest.fixture(autouse=True)
def python_colmap(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def build_colmap_bin_scene(root, n_frames=12, size=40):
    """A binary COLMAP model: one SIMPLE_PINHOLE and one PINHOLE camera, RGBA
    and RGB images named by frame index."""
    sparse = os.path.join(root, "sparse/0")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(1)
    write_points3d_bin(os.path.join(sparse, "points3D.bin"), rng.normal(size=(30, 3)),
                       rng.integers(0, 255, (30, 3)).astype(np.float64),
                       rng.uniform(0, 1, 30))
    write_cameras_bin(os.path.join(sparse, "cameras.bin"),
                      [(1, 0, size, size - 8, [45.0, 20.0, 16.0]),
                       (2, 1, size, size - 8, [44.0, 47.0, 20.0, 16.0])])
    q = rng.normal(size=(n_frames, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    write_images_bin(os.path.join(sparse, "images.bin"),
                     [(i + 1, q[i], rng.normal(size=3), 1 + i % 2, f"{i:04d}.png")
                      for i in reversed(range(n_frames))])
    for i in range(n_frames):
        mode, ch = ("RGBA", 4) if i % 2 else ("RGB", 3)
        img = rng.integers(0, 256, (size - 8, size, ch)).astype(np.uint8)
        Image.fromarray(img, mode).save(os.path.join(root, "images", f"{i:04d}.png"))
    return root


def build_scene(kind, root):
    if kind == "colmap_bin":
        return build_colmap_bin_scene(root)
    if kind == "colmap_text":
        return build_colmap_scene(root, n_frames=11)
    if kind in ("blender", "blender_white"):
        return build_blender_scene(root, n_views=4, n_test=2, size=24)
    return build_nerfies_scene(pathlib.Path(root))


def twin_copies(kind, tmp_path):
    """The scene once, copied for each package."""
    src = build_scene(kind, str(tmp_path / "src" / kind))
    out = []
    for who in ("jax", "port"):
        dst = str(tmp_path / who / os.path.relpath(src, str(tmp_path / "src")))
        shutil.copytree(src, dst)
        out.append(dst)
    return out


def assert_same_info(a, b, roots):
    """CameraInfo records bitwise equal, PIL images included; image paths
    the same within each package's copy of the scene."""
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "image_path":
            assert os.path.relpath(x, roots[0]) == os.path.relpath(y, roots[1])
        elif f == "image":
            assert x.size == y.size and x.mode == y.mode
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert type(x) is type(y), f


def assert_same_camera(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.tan_fovx == b.tan_fovx and a.tan_fovy == b.tan_fovy


KINDS = ["colmap_bin", "colmap_text", "blender", "blender_white", "nerfies"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("eval_split", [False, True], ids=["all", "eval"])
def test_scene_matches_jax(kind, eval_split, tmp_path):
    jsrc, tsrc = twin_copies(kind, tmp_path)
    kw = dict(eval=eval_split, white_background=kind == "blender_white",
              random_init_points=500, resolution=2 if kind == "colmap_bin" else -1)
    np.random.seed(SEED)
    random.seed(SEED)
    js = jscene.Scene(jsrc, str(tmp_path / "jax_model"), **kw)
    ts = scene.Scene(tsrc, str(tmp_path / "port_model"), rng=np.random.RandomState(SEED),
                     shuffle_rng=random.Random(SEED), **kw)

    ji, ti = js.scene_info, ts.scene_info
    for split in ("train_cameras", "test_cameras"):
        assert len(getattr(ji, split)) == len(getattr(ti, split))
        for a, b in zip(getattr(ji, split), getattr(ti, split)):
            assert_same_info(a, b, (jsrc, tsrc))
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(ji.point_cloud, f), getattr(ti.point_cloud, f))
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(ji.nerf_normalization[k], ti.nerf_normalization[k])
    assert js.cameras_extent == ts.cameras_extent
    assert os.path.relpath(ji.ply_path, jsrc) == os.path.relpath(ti.ply_path, tsrc)

    for getter in ("get_train_cameras", "get_test_cameras"):
        jc, tc = getattr(js, getter)(), getattr(ts, getter)()
        assert [c.image_name for c in jc] == [c.image_name for c in tc]  # shuffled order
        for a, b in zip(jc, tc):
            assert_same_camera(a, b)
    assert js.point_cloud_dir(30).replace("jax_model", "m") == \
        ts.point_cloud_dir(30).replace("port_model", "m")

    def read(p):
        with open(p, "rb") as f:
            return f.read()

    assert read(ji.ply_path) == read(ti.ply_path)
    for name in ("input.ply", "cameras.json"):
        assert read(str(tmp_path / "jax_model" / name)) == read(str(tmp_path / "port_model" / name))


@pytest.mark.parametrize("kind", KINDS)
def test_detect_scene_type(kind, tmp_path):
    root = build_scene(kind, str(tmp_path / kind))
    assert readers.detect_scene_type(root) == jreaders.detect_scene_type(root)
    with pytest.raises(ValueError, match="scene type"):
        readers.detect_scene_type(str(tmp_path))


@pytest.mark.parametrize("shape", [(5, 3), (1, 3)], ids=["cloud", "one_point"])
def test_random_bbox_cloud(shape):
    xyz = np.random.default_rng(3).normal(size=shape)
    np.random.seed(SEED)
    a = jreaders._random_bbox_cloud(xyz, 1000)
    b = readers._random_bbox_cloud(xyz, 1000, np.random.RandomState(SEED))
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("args", [(800, 600, -1, 1.0), (2000, 1000, -1, 1.0),
                                  (2000, 1000, -1, 2.0), (640, 480, 2, 1.0),
                                  (640, 480, 8, 0.5), (1200, 900, 500, 1.0)])
def test_resolve_resolution(args):
    assert cameras._resolve_resolution(*args) == jcameras._resolve_resolution(*args)


def test_camera_without_image():
    rng = np.random.default_rng(4)
    R = jcolmap.qvec2rotmat(rng.normal(size=4) / 2).T
    info = dict(uid=3, R=R, T=rng.normal(size=3), fovx=0.9, fovy=0.7, image=None,
                image_path="", image_name="x", width=64, height=48, time=0.25)
    a = jcameras.load_camera(jcameras.CameraInfo(**info), 5, 1, 1.0)
    b = cameras.load_camera(cameras.CameraInfo(**info), 5, 1, 1.0)
    assert b.image is None
    assert_same_camera(a, b)
    assert jcameras.camera_to_json(2, jcameras.CameraInfo(**info)) == \
        cameras.camera_to_json(2, cameras.CameraInfo(**info))
    np.testing.assert_array_equal(jtf.camera_center_from_view(a.world_view),
                                  tf.camera_center_from_view(b.world_view))


@pytest.mark.parametrize("fmt", ["bin", "text"])
def test_colmap_parsers(fmt, tmp_path):
    root = (build_colmap_bin_scene if fmt == "bin" else build_colmap_scene)(str(tmp_path / fmt))
    sparse = os.path.join(root, "sparse/0")
    ext = "bin" if fmt == "bin" else "txt"
    for name, what in (("points3D", "read_points3d"), ("cameras", "read_intrinsics"),
                       ("images", "read_extrinsics")):
        fn = f"{what}_{'binary' if fmt == 'bin' else 'text'}"
        path = os.path.join(sparse, f"{name}.{ext}")
        a, b = getattr(jcolmap, fn)(path), getattr(colmap, fn)(path)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            continue
        assert list(a) == list(b)
        for k in a:
            assert a[k]._fields == b[k]._fields
            for f in a[k]._fields:
                np.testing.assert_array_equal(getattr(a[k], f), getattr(b[k], f), err_msg=f)


def test_quaternion_maps():
    rng = np.random.default_rng(5)
    for q in rng.normal(size=(20, 4)):
        q /= np.linalg.norm(q)
        R = colmap.qvec2rotmat(q)
        np.testing.assert_array_equal(R, jcolmap.qvec2rotmat(q))
        np.testing.assert_array_equal(colmap.rotmat2qvec(R), jcolmap.rotmat2qvec(R))
        np.testing.assert_allclose(colmap.rotmat2qvec(R), q * np.sign(q[0]), atol=1e-12)
    assert colmap.CAMERA_MODELS == jcolmap.CAMERA_MODELS

