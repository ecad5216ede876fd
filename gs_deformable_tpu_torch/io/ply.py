"""Minimal PLY reader (binary_little_endian and ascii).

The port's own copy of ``read_ply`` from ``gs_deformable_tpu/io/ply.py``:
one ``vertex`` element with scalar properties.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1", "short": "<i2",
    "ushort": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4",
}


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
