"""The port's native COLMAP reader (``io/native.py``, ``csrc/colmap_io.cpp``).

On the binary models that tests/test_colmap.py writes: the port's binary
readers through the native library, the same readers forced onto the
Python parser, and the JAX package's readers (native and Python) agree
bitwise in every field that both return.  The native images reader skips
the 2D tracks, as the JAX one does: ``xys`` (0, 2), ``point3d_ids`` (0,)
int64.  Edge files: 0 points, a 200-character image name, truncated files
(the native reader returns None and the Python parser then reads or raises
as the JAX package's does; a file cut inside an image name raises EOFError
in the port, where the JAX parser never returns).  The library builds
with the host compiler at first use, into the directory ``_build`` is
given.
"""

import os
import struct

import numpy as np
import pytest

from test_colmap import write_cameras_bin, write_images_bin, write_points3d_bin

from gs_deformable_tpu.data import colmap as jcolmap
from gs_deformable_tpu.io import native as jnative
from gs_deformable_tpu_torch import _build
from gs_deformable_tpu_torch.data import colmap
from gs_deformable_tpu_torch.io import native


def write_model(root, rng, n_points=50, n_images=3, names=None):
    xyz = rng.normal(size=(n_points, 3))
    rgb = rng.integers(0, 255, (n_points, 3)).astype(np.float64)
    err = rng.uniform(0, 1, n_points)
    write_points3d_bin(os.path.join(root, "points3D.bin"), xyz, rgb, err)
    cams = [(1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),
            (2, 4, 800, 600, list(rng.uniform(-1, 1, 8))),
            (3, 6, 32, 16, list(rng.uniform(-1, 1, 12)))]
    write_cameras_bin(os.path.join(root, "cameras.bin"), cams)
    q = rng.normal(size=(n_images, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    names = names or [f"{i:04d}.png" for i in range(n_images)]
    imgs = [(i + 1, q[i], rng.normal(size=3), 1 + i % 3, names[i]) for i in range(n_images)]
    write_images_bin(os.path.join(root, "images.bin"), imgs)
    return xyz, rgb, err


def read_all(mod, root):
    return (mod.read_points3d_binary(os.path.join(root, "points3D.bin")),
            mod.read_intrinsics_binary(os.path.join(root, "cameras.bin")),
            mod.read_extrinsics_binary(os.path.join(root, "images.bin")))


def python_only(monkeypatch, *mods):
    for mod in mods:
        monkeypatch.setattr(mod, "available", lambda: False)


def assert_same(a, b, tracks):
    """Bitwise equal models; ``tracks``: compare the 2D tracks too."""
    for x, y in zip(a[0], b[0], strict=True):
        assert x.dtype == y.dtype == np.float64
        np.testing.assert_array_equal(x, y)
    assert list(a[1]) == list(b[1])
    for k in a[1]:
        ca, cb = a[1][k], b[1][k]
        assert (ca.id, ca.model, ca.width, ca.height) == (cb.id, cb.model, cb.width, cb.height)
        assert ca.params.dtype == cb.params.dtype
        np.testing.assert_array_equal(ca.params, cb.params)
    assert list(a[2]) == list(b[2])
    for k in a[2]:
        ia, ib = a[2][k], b[2][k]
        assert (ia.id, ia.camera_id, ia.name) == (ib.id, ib.camera_id, ib.name)
        np.testing.assert_array_equal(ia.qvec, ib.qvec)
        np.testing.assert_array_equal(ia.tvec, ib.tvec)
        if tracks:
            np.testing.assert_array_equal(ia.xys, ib.xys)
            np.testing.assert_array_equal(ia.point3d_ids, ib.point3d_ids)


def test_native_available_and_used(tmp_path, rng, monkeypatch):
    assert native.available()
    xyz, rgb, err = write_model(str(tmp_path), rng)
    calls = []
    for name in ("read_points3d_bin", "read_cameras_bin", "read_images_bin"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name, lambda p, fn=fn, name=name: calls.append(name) or fn(p))
    pts, cams, imgs = read_all(colmap, str(tmp_path))
    assert sorted(calls) == ["read_cameras_bin", "read_images_bin", "read_points3d_bin"]
    np.testing.assert_array_equal(pts[0], xyz)
    np.testing.assert_array_equal(pts[1], rgb)
    np.testing.assert_array_equal(pts[2][:, 0], err)
    for im in imgs.values():
        assert im.xys.shape == (0, 2) and im.point3d_ids.shape == (0,)
        assert im.point3d_ids.dtype == np.int64


@pytest.mark.parametrize("n_points,n_images", [(50, 3), (0, 1), (7, 0)])
def test_native_matches_python_and_jax(tmp_path, rng, monkeypatch, n_points, n_images):
    root = str(tmp_path)
    write_model(root, rng, n_points, n_images)
    assert native.available() and jnative.available()
    port_native = read_all(colmap, root)
    jax_native = read_all(jcolmap, root)
    python_only(monkeypatch, native, jnative)
    port_python = read_all(colmap, root)
    jax_python = read_all(jcolmap, root)
    assert_same(port_native, port_python, tracks=False)
    assert_same(port_native, jax_native, tracks=True)
    assert_same(port_python, jax_python, tracks=True)
    for im in port_python[2].values():
        assert im.xys.shape == (2, 2)


def test_long_image_name(tmp_path, rng, monkeypatch):
    name = "v" * 196 + ".png"
    assert len(name) == 200
    root = str(tmp_path)
    write_model(root, rng, 5, 2, names=[name, "b/" + name[2:]])
    got = read_all(colmap, root)
    assert [im.name for im in got[2].values()] == [name, "b/" + name[2:]]
    assert_same(got, read_all(jcolmap, root), tracks=True)
    python_only(monkeypatch, native)
    assert_same(got, read_all(colmap, root), tracks=False)


def truncate(path, drop):
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data[:len(data) - drop])


def outcome(fn, path):
    """("raised", type, message) or ("read", result) of ``fn(path)``."""
    try:
        return ("read", fn(path))
    except Exception as e:  # the outcome itself is what the test compares
        return ("raised", type(e), str(e))


@pytest.mark.parametrize("fname,reader,drop", [
    ("points3D.bin", "read_points3d_binary", 5),  # inside the last track
    ("points3D.bin", "read_points3d_binary", 40),  # inside the last record
    ("cameras.bin", "read_intrinsics_binary", 3),
    ("images.bin", "read_extrinsics_binary", 30),
])
def test_truncated_file_falls_back(tmp_path, rng, fname, reader, drop):
    """The native reader refuses a truncated file (None); the Python parser
    then reads it as the JAX package's does: the same error, or (a cut
    inside the last skipped track) the same arrays."""
    root = str(tmp_path)
    write_model(root, rng, 6, 3, names=["a" * 40 + ".png"] * 3)
    path = os.path.join(root, fname)
    truncate(path, drop)
    raw = {"points3D.bin": native.read_points3d_bin, "cameras.bin": native.read_cameras_bin,
           "images.bin": native.read_images_bin}[fname]
    assert raw(path) is None
    got = outcome(getattr(colmap, reader), path)
    want = outcome(getattr(jcolmap, reader), path)
    assert got[0] == want[0] == ("read" if drop == 5 else "raised")
    if got[0] == "raised":
        assert got == want
    else:
        for a, b in zip(got[1], want[1], strict=True):
            np.testing.assert_array_equal(a, b)


def test_truncated_image_name(tmp_path, rng):
    """A file that ends inside an image name: the native reader returns
    None and the port's Python parser raises EOFError.  (The JAX package's
    Python parser reads empty bytes forever there, so it is not run.)"""
    root = str(tmp_path)
    write_model(root, rng, 6, 3, names=["a" * 40 + ".png"] * 3)
    path = os.path.join(root, "images.bin")
    truncate(path, 70)  # the last image's 45-byte name ends 56 bytes before the end
    assert native.read_images_bin(path) is None
    with pytest.raises(EOFError, match="inside an image name"):
        colmap.read_extrinsics_binary(path)


def test_missing_file_falls_back(tmp_path):
    path = str(tmp_path / "none.bin")
    assert native.read_points3d_bin(path) is None
    with pytest.raises(FileNotFoundError):
        colmap.read_points3d_binary(path)


def test_header_only_file(tmp_path):
    path = str(tmp_path / "points3D.bin")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", 0))
    xyz, rgb, err = colmap.read_points3d_binary(path)
    assert xyz.shape == rgb.shape == (0, 3) and err.shape == (0, 1)


def test_builds_with_host_compiler(tmp_path, rng, monkeypatch):
    """A fresh build directory: ``available()`` compiles the library with the
    host compiler under a source-hash name and reads through it."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", False)
    assert native.available()
    built = os.listdir(tmp_path / "build")
    assert len(built) == 1 and built[0].startswith("libcolmap_io-") and built[0].endswith(".so")
    assert built[0] == os.path.basename(_build._target("colmap_io"))
    root = str(tmp_path / "model")
    os.makedirs(root)
    xyz, _, _ = write_model(root, rng)
    np.testing.assert_array_equal(read_all(colmap, root)[0][0], xyz)


def test_no_host_compiler_parses_in_python(tmp_path, rng, monkeypatch):
    def missing():
        raise RuntimeError("no host C++ compiler (c++ or g++) found")

    monkeypatch.setattr(_build, "host_compiler", missing)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SEARCHED", False)
    assert not native.available()
    root = str(tmp_path)
    write_model(root, rng)
    imgs = read_all(colmap, root)[2]
    assert all(im.xys.shape == (2, 2) for im in imgs.values())
