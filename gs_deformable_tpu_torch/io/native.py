"""ctypes bindings for the port's native COLMAP reader (``csrc/colmap_io.cpp``).

The port's own copy of ``gs_deformable_tpu/io/native.py``.  The library is
built at first use by ``_build`` with the host compiler into the package's
``kernels_build/``; it needs no ``nvcc`` and no GPU.  ``available()`` is
False only where no host compiler exists, and then the binary readers of
``data/colmap.py`` parse in Python.  Each reader returns None when the
library's read fails (a missing or truncated file), and the caller falls
back to the Python parser, as the JAX package does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .. import _build

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    try:
        _build.host_compiler()
    except RuntimeError:
        return None
    lib = _build.load("colmap_io", {})
    lib.gsio_read_points3d_bin.restype = ctypes.POINTER(ctypes.c_double)
    lib.gsio_read_points3d_bin.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gsio_read_images_bin.restype = ctypes.POINTER(ctypes.c_double)
    lib.gsio_read_images_bin.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gsio_read_cameras_bin.restype = ctypes.POINTER(ctypes.c_double)
    lib.gsio_read_cameras_bin.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gsio_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library is built (building it now if needed)."""
    return _find_lib() is not None


def read_points3d_bin(path: str):
    """-> (xyz (N,3), rgb (N,3), err (N,1)) float64, or None if the read failed."""
    lib = _find_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    ptr = lib.gsio_read_points3d_bin(path.encode(), ctypes.byref(n))
    if not ptr or n.value < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(n.value, 7)).copy()
    finally:
        lib.gsio_free(ptr)
    return arr[:, 0:3], arr[:, 3:6], arr[:, 6:7]


def read_images_bin(path: str):
    """-> list of dicts {id, qvec, tvec, camera_id, name}, or None.  The 2D
    tracks are not read."""
    lib = _find_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    names_p = ctypes.c_char_p()
    names_len = ctypes.c_int64()
    ptr = lib.gsio_read_images_bin(path.encode(), ctypes.byref(n), ctypes.byref(names_p),
                                   ctypes.byref(names_len))
    if not ptr or n.value < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(n.value, 9)).copy()
        names = ctypes.string_at(names_p, names_len.value).decode().split("\n")[:-1]
    finally:
        lib.gsio_free(ptr)
        lib.gsio_free(names_p)
    return [{"id": int(row[0]), "qvec": row[1:5].copy(), "tvec": row[5:8].copy(),
             "camera_id": int(row[8]), "name": name} for row, name in zip(arr, names, strict=True)]


def read_cameras_bin(path: str):
    """-> list of dicts {id, model_id, width, height, params (12, zero-padded)}, or None."""
    lib = _find_lib()
    if lib is None:
        return None
    n = ctypes.c_int64()
    ptr = lib.gsio_read_cameras_bin(path.encode(), ctypes.byref(n))
    if not ptr or n.value < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(n.value, 16)).copy()
    finally:
        lib.gsio_free(ptr)
    return [{"id": int(row[0]), "model_id": int(row[1]), "width": int(row[2]),
             "height": int(row[3]), "params": row[4:16].copy()} for row in arr]
