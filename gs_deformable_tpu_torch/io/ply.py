"""Minimal PLY reader and writer (binary_little_endian; ascii read).

The port's own copy of ``gs_deformable_tpu/io/ply.py``: one ``vertex``
element with scalar properties.  Covers the input point clouds
(``store_point_cloud`` / ``fetch_point_cloud``) and the trained-model
schema of ``io/model_ply.py``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1", "short": "<i2",
    "ushort": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int", "u4": "uint"}


def write_ply(path: str, names: List[str], columns: List[np.ndarray]) -> None:
    """Write one binary ``vertex`` element with the given scalar properties."""
    n = len(columns[0])
    dtype = np.dtype([(name, col.dtype.newbyteorder("<")) for name, col in zip(names, columns)])
    rec = np.empty(n, dtype=dtype)
    for name, col in zip(names, columns):
        rec[name] = col
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property {_NP_TO_PLY[col.dtype.str.lstrip('<>|=')]} {name}"
               for name, col in zip(names, columns)]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the ``vertex`` element into a dict of 1-D arrays."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n = None
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: header has no end_header")
            line = raw.decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    n = int(cnt)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2], _PLY_TO_NP[parts[1]]))
            elif line == "end_header":
                break
        if n is None:
            raise ValueError(f"{path}: no vertex element")
        dtype = np.dtype(props)
        if fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        elif fmt == "ascii":
            rows = [f.readline().split() for _ in range(n)]
            rec = np.array([tuple(row[: len(props)]) for row in rows], dtype=dtype)
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(rec[name]) for name, _ in props}


def store_point_cloud(path: str, xyz: np.ndarray, rgb255: np.ndarray) -> None:
    """xyz (float32), zero normals and uchar RGB (values truncated to uint8)."""
    zeros = np.zeros(len(xyz), np.float32)
    xyz = xyz.astype(np.float32)
    rgb = rgb255.astype(np.uint8)
    write_ply(path, ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"],
              [xyz[:, 0], xyz[:, 1], xyz[:, 2], zeros, zeros, zeros,
               rgb[:, 0], rgb[:, 1], rgb[:, 2]])


def fetch_point_cloud(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points float32, colours in [0, 1] float32, normals float32; zeros
    when the file has none)."""
    d = read_ply(path)
    pts = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    cols = np.stack([d["red"], d["green"], d["blue"]], -1).astype(np.float32) / 255.0
    if "nx" in d:
        normals = np.stack([d["nx"], d["ny"], d["nz"]], -1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals
