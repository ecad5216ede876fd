"""The port's multi-host pieces (``parallel/multihost.py``) on the CPU.

Four processes with torchrun's variables for 2 hosts x 2 ranks (``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` 2, ``WORLD_SIZE`` 4, a free localhost
port) join through ``initialize_from_env(device="cpu")`` (gloo) and run
tests/torch_mesh_child.py's multihost cases once for the module: the
global 2x2 mesh, the data rows each host feeds, and 3 sharded steps of
tests/test_sharding.py's scene fed only the host's own rows, which must be
bitwise the same run as one fed every row (tests/test_multihost.py's
check for JAX).  The layout functions are also checked without processes.
"""

import os
import pickle
import socket

import numpy as np
import pytest

from test_torch_sharding import assert_equal_trees, collect, make_inputs, spawn

from gs_deformable_tpu_torch.parallel import multihost, sharding


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("multihost")
    _, _, inp = make_inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    port = str(free_port())

    def env(rank):
        return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port, "WORLD_SIZE": "4",
                "RANK": str(rank), "LOCAL_RANK": str(rank % 2), "LOCAL_WORLD_SIZE": "2"}

    return collect(spawn("multihost", work, env), work)


def test_initialize_from_env(ranks):
    for r, res in enumerate(ranks):
        assert (res["rank"], res["world"], res["backend"]) == (r, 4, "gloo")
        assert res["coords"] == divmod(r, 2)


def test_hosts_feed_their_own_rows(ranks):
    assert [res["rows"] for res in ranks] == [[0], [0], [1], [1]]
    assert [res["local"]["held_rows"] for res in ranks] == [[0], [0], [1], [1]]
    assert all(res["all"]["held_rows"] == [0, 1] for res in ranks)


def test_local_feed_equals_full_feed(ranks):
    for r, res in enumerate(ranks):
        assert_equal_trees(res["local"]["state"], res["all"]["state"], f"rank {r}")
        assert_equal_trees(res["local"]["metrics"], res["all"]["metrics"], f"rank {r}")
        assert np.isfinite(float(res["local"]["metrics"]["loss"]))
        assert_equal_trees(res["local"]["state"], ranks[0]["local"]["state"], f"rank {r}")


@pytest.mark.parametrize("n_data,n_model,local_world,rows", [
    (2, 2, 2, [[0], [0], [1], [1]]),  # the model axis inside each host
    (4, 1, 2, [[0, 1], [0, 1], [2, 3], [2, 3]]),
    (1, 4, 2, [[0]] * 4),  # a model group spanning both hosts
    (2, 2, 4, [[0, 1]] * 4),  # one host
])
def test_local_data_indices_layouts(n_data, n_model, local_world, rows):
    got = []
    for rank in range(4):
        mesh = sharding.Mesh(n_data, n_model, *divmod(rank, n_model), device="cpu")
        got.append(multihost.local_data_indices(mesh, local_world_size=local_world))
    assert got == rows


def test_global_mesh_needs_the_world_size():
    with pytest.raises(ValueError, match="world size is 1"):
        multihost.global_mesh(2, 2, device="cpu")
    assert multihost.global_mesh(1, 1, device="cpu").rank == 0


def test_initialize_needs_torchrun_variables(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize_from_env(device="cpu")
