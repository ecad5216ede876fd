"""Network-viewer bridge: interactive views during training.

The port's own copy of ``gs_deformable_tpu/viewer.py``, with its wire
format: each message from the viewer is a 4-byte little-endian length and
that many bytes of UTF-8 JSON (the viewer camera: resolution, fovs,
flattened view and view-projection matrices, training-control flags, and an
optional "time"); each answer is the raw H x W x 3 uint8 render, then a
length-prefixed ASCII source path.  The view matrices' second and third
columns change sign for the viewer's convention.

Two changes from the JAX module: ``read`` loops until the whole message has
arrived (one ``recv`` may return part of it), and ``try_connect`` can wait
for a client for a given time.
"""

from __future__ import annotations

import json
import socket
import traceback
from typing import Optional

import numpy as np

_listener: Optional[socket.socket] = None
conn: Optional[socket.socket] = None
addr = None

host = "127.0.0.1"
port = 6009


def init(wish_host: str, wish_port: int) -> None:
    """Listen on (``wish_host``, ``wish_port``); port 0 takes a free one."""
    global host, port, _listener
    host, port = wish_host, wish_port
    _listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    _listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    _listener.bind((host, port))
    _listener.listen()
    _listener.settimeout(0)


def close() -> None:
    """Close the connection and the listener."""
    global _listener, conn
    for s in (conn, _listener):
        if s is not None:
            s.close()
    conn = _listener = None


def try_connect(timeout: float = 0.0) -> None:
    """Accept a waiting client, waiting up to ``timeout`` seconds (0: only
    one that is already there)."""
    global conn, addr
    if _listener is None:
        return
    _listener.settimeout(timeout)
    try:
        conn, addr = _listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except OSError:
        pass
    finally:
        _listener.settimeout(0)


def _recv_exactly(n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError(f"viewer closed the connection after {len(buf)} of {n} bytes")
        buf += part
    return bytes(buf)


def read() -> dict:
    """One length-prefixed JSON message, read whole."""
    length = int.from_bytes(_recv_exactly(4), "little")
    return json.loads(_recv_exactly(length).decode("utf-8"))


def send(message_bytes, verify: str) -> None:
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive():
    """(camera dict or None, do_training, convert_shs, compute_cov3d,
    keep_alive, scaling_modifier) from the next message.

    The camera dict carries width, height, fovx, fovy, znear, zfar, time and
    the row-vector ``world_view``, ``full_proj`` and ``camera_center`` the
    renderer takes.  A stock viewer sends no time: its views are at t = 0.
    """
    message = read()
    width = message["resolution_x"]
    height = message["resolution_y"]
    if width == 0 or height == 0:
        return None, None, None, None, None, None
    try:
        world_view = np.reshape(np.array(message["view_matrix"]), (4, 4))
        world_view[:, 1] = -world_view[:, 1]
        world_view[:, 2] = -world_view[:, 2]
        full_proj = np.reshape(np.array(message["view_projection_matrix"]), (4, 4))
        full_proj[:, 1] = -full_proj[:, 1]
        camera = {
            "time": float(message.get("time", 0.0)),
            "width": width,
            "height": height,
            "fovx": message["fov_x"],
            "fovy": message["fov_y"],
            "znear": message["z_near"],
            "zfar": message["z_far"],
            "world_view": world_view.astype(np.float32),
            "full_proj": full_proj.astype(np.float32),
            "camera_center": np.linalg.inv(world_view)[3, :3].astype(np.float32),
        }
        flags = (bool(message["train"]), bool(message["shs_python"]),
                 bool(message["rot_scale_python"]), bool(message["keep_alive"]))
        scaling_modifier = message["scaling_modifier"]
    except Exception:
        print("")
        traceback.print_exc()
        raise
    return (camera, *flags, scaling_modifier)


def image_to_bytes(img_chw: np.ndarray) -> memoryview:
    """A (3, H, W) float image clamped to [0, 1] as H x W x 3 uint8 bytes."""
    arr = np.clip(img_chw, 0.0, 1.0)
    return memoryview(np.ascontiguousarray((arr * 255).astype(np.uint8).transpose(1, 2, 0)))
