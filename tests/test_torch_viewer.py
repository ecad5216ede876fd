"""The port's viewer bridge, video writer and console stamping.

The viewer keeps the wire format of the JAX package's (tests/test_viewer.py):
a 4-byte little-endian length and UTF-8 JSON in, the raw H x W x 3 render
and a length-prefixed source path out.  The server here waits for the
client's connection, and ``read`` takes a message that arrives in pieces
across many ``recv`` calls.  ``frames_to_video`` writes a GIF through
Pillow.
"""

import json
import re
import socket
import threading
import time

import numpy as np
import pytest
from PIL import Image

from gs_deformable_tpu_torch import video, viewer


def message(**extra):
    return {"resolution_x": 8, "resolution_y": 6, "train": True, "fov_y": 0.7, "fov_x": 0.9,
            "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
            "keep_alive": True, "scaling_modifier": 1.0, "time": 0.37,
            "view_matrix": list(np.eye(4).flatten()),
            "view_projection_matrix": list(np.eye(4).flatten()), **extra}


@pytest.fixture
def server():
    viewer.init("127.0.0.1", 0)
    yield viewer._listener.getsockname()[1]
    viewer.close()


def client(port, payload, received, pieces=1, img_bytes=8 * 6 * 3, timeout=10):
    """Connect, send ``payload`` length-prefixed in ``pieces`` writes, read
    ``img_bytes`` of render and the source path."""
    c = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    data = len(payload).to_bytes(4, "little") + payload
    step = -(-len(data) // pieces)
    for i in range(0, len(data), step):
        c.sendall(data[i:i + step])
        if pieces > 1:
            time.sleep(0.002)
    img = b""
    while len(img) < img_bytes:
        img += c.recv(img_bytes - len(img))
    n = int.from_bytes(c.recv(4), "little")
    received["img"], received["verify"] = img, c.recv(n).decode()
    c.close()


@pytest.mark.parametrize("pieces", [1, 40])
def test_viewer_round_trip(server, pieces):
    """One message, whole or in 40 writes with pauses (so ``recv`` returns
    it in parts), padded past 200 kB: the camera decodes, the render and
    the source path go back."""
    payload = json.dumps(message(padding="x" * 200_000)).encode()
    received = {}
    t = threading.Thread(target=client, args=(server, payload, received, pieces))
    t.start()
    viewer.try_connect(timeout=10)
    assert viewer.conn is not None
    cam, do_training, shs_py, cov_py, keep_alive, smod = viewer.receive()
    assert cam["width"] == 8 and cam["height"] == 6 and abs(cam["time"] - 0.37) < 1e-9
    assert do_training and keep_alive and smod == 1.0 and not shs_py and not cov_py
    np.testing.assert_allclose(cam["world_view"][:, 1], [0, -1, 0, 0])
    np.testing.assert_allclose(cam["full_proj"][:, 1], [0, -1, 0, 0])
    np.testing.assert_allclose(cam["camera_center"], [0, 0, 0])
    img = np.random.default_rng(0).uniform(0, 1, (3, 6, 8)).astype(np.float32)
    viewer.send(viewer.image_to_bytes(img), "srcpath")
    t.join(timeout=10)
    assert received["verify"] == "srcpath"
    got = np.frombuffer(received["img"], np.uint8).reshape(6, 8, 3)
    np.testing.assert_array_equal(got, (img * 255).astype(np.uint8).transpose(1, 2, 0))


def test_viewer_empty_view_and_no_client(server):
    viewer.try_connect()  # nobody there: returns at once
    assert viewer.conn is None
    received = {}
    payload = json.dumps(message(resolution_x=0)).encode()
    t = threading.Thread(target=client, args=(server, payload, received, 1, 0))
    t.start()
    viewer.try_connect(timeout=10)
    assert viewer.receive() == (None,) * 6
    viewer.send(None, "src")  # no render: only the source path
    t.join(timeout=10)
    assert received["verify"] == "src"


def test_frames_to_video_gif(tmp_path):
    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (16, 24, 3), dtype=np.uint8)).save(
            frames / f"{i:05d}.png")
    (frames / "notes.txt").write_text("not a frame")
    out = video.frames_to_video(str(frames), str(tmp_path / "clip.gif"), fps=5)
    assert out.endswith("clip.gif")
    with Image.open(out) as gif:
        assert gif.n_frames == 4 and gif.size == (24, 16)
    with pytest.raises(FileNotFoundError):
        video.frames_to_video(str(tmp_path), str(tmp_path / "x.gif"))


def test_trainer_serves_viewer(tmp_path, monkeypatch):
    """The trainer with its viewer on: a client that connects as the
    listener opens gets a render of the training state (se3 with the gate)
    at its camera, and training goes on when it hangs up."""
    from synthetic_scene import build_blender_scene

    from gs_deformable_tpu_torch import train

    scene = str(tmp_path / "scene")
    build_blender_scene(scene, n_views=3, n_test=1, size=32, n_blobs=6)
    view = np.eye(4)
    view[3, 2] = 4.0  # 4 in front of the cloud
    payload = json.dumps(message(view_matrix=list(view.flatten()),
                                 view_projection_matrix=list(view.flatten()))).encode()
    received, threads = {}, []
    listen = viewer.init

    def init_then_connect(host, port):
        # The client connects once the trainer listens, before its first
        # step, so the first poll of the loop accepts it.
        listen(host, port)
        # A render of the trainer's first frame on a busy CPU can take tens
        # of seconds: the client waits up to 300 s for it.
        threads.append(threading.Thread(
            target=client, args=(viewer._listener.getsockname()[1], payload, received),
            kwargs={"timeout": 300}))
        threads[0].start()

    monkeypatch.setattr(viewer, "init", init_then_connect)
    try:
        tl = []
        train.main(["-s", scene, "-m", str(tmp_path / "out"), "--iterations", "12",
                    "--deform_mode", "se3", "--use_opacity_mask", "--random_init_points", "100",
                    "--instance_capacity", "2048", "--chunk", "8",
                    "--sh_degree", "0", "--warmup_iters", "3", "--densify_from_iter", "100000",
                    "--test_iterations", "-1", "--save_iterations", "-1", "--port", "0",
                    "--quiet", "--device", "cpu"], tl)
    finally:
        threads[0].join(timeout=300)
        viewer.close()
    assert received["verify"] == scene
    assert len(received["img"]) == 8 * 6 * 3
    assert [r["to"] for r in tl if r["stage"] == "steps"][-1] == 12


def test_safe_state_stamps_and_seeds_only_what_it_is_given(capsys):
    import random
    import sys

    import torch

    from gs_deformable_tpu_torch.utils.general import safe_state

    before = (random.getstate(), np.random.get_state()[1].copy(), torch.random.get_rng_state())
    stdout = sys.stdout
    try:
        safe_state(False)
        print("line")
        safe_state(True)
        print("hidden")
    finally:
        sys.stdout = stdout
    out = capsys.readouterr().out
    assert re.fullmatch(r"line \[\d\d/\d\d \d\d:\d\d:\d\d\]\n", out), out
    assert random.getstate() == before[0]
    np.testing.assert_array_equal(np.random.get_state()[1], before[1])
    assert torch.equal(torch.random.get_rng_state(), before[2])
