"""Joining the process group from torchrun's environment, the global mesh and
host-local data feeding.

Port of ``gs_deformable_tpu/parallel/multihost.py``.  ``torchrun`` (or
``python -m torch.distributed.run``) starts one process per device on every
host and sets ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``; ranks are numbered host by host.
The mesh puts the model axis on consecutive ranks, so a model group stays
inside one host whenever ``n_model`` divides the host's ranks; each host
feeds only the cameras of its own data rows (``local_data_indices``).
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import device as device_rules
from .sharding import Mesh, make_mesh

# A collective that one rank never reaches fails the run after this long
# instead of hanging it.
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"{name} is not set: start the ranks with torchrun")
        return default
    return int(value)


def initialize_from_env(device="cuda", backend: Optional[str] = None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """``dist.init_process_group`` from torchrun's variables; returns this
    rank's device.

    On CUDA each rank takes card ``LOCAL_RANK % device_count``.  The backend
    defaults to NCCL when every rank of the host has a card of its own, and
    to gloo for ``device="cpu"`` or for more ranks on a host than cards
    (NCCL refuses two ranks on one card; gloo's collectives take CUDA
    tensors and copy them through host memory themselves).  ``timeout_s``
    bounds every collective."""
    dev = device_rules.resolve(device)
    world = _env_int("WORLD_SIZE")
    rank = _env_int("RANK")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError("MASTER_ADDR and MASTER_PORT must be set: start the ranks "
                           "with torchrun")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(dev)
        if backend is None:
            backend = "nccl" if local_world <= n_cards else "gloo"
    dist.init_process_group(backend or "gloo", init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def global_mesh(n_data: int, n_model: int, device="cuda") -> Mesh:
    """The mesh over every rank of the process group (``sharding.make_mesh``):
    the model axis on consecutive ranks, so within a host first
    (multihost.py:42-49 of the JAX package); the data rows span hosts, whose
    only traffic is the sum of the gradients.  Raises ``ValueError`` when
    the world size is not ``n_data * n_model``."""
    return make_mesh(n_data, n_model, device)


def local_data_indices(mesh: Mesh, rank: Optional[int] = None,
                       local_world_size: Optional[int] = None) -> List[int]:
    """The data rows that this rank's host feeds: the rows of the ranks on
    the same host (multihost.py:52-60).  ``local_world_size`` defaults to
    ``LOCAL_WORLD_SIZE``, or to the whole world when it is not set."""
    rank = mesh.rank if rank is None else rank
    world = mesh.n_data * mesh.n_model
    lw = local_world_size or _env_int("LOCAL_WORLD_SIZE", world)
    host = rank // lw
    ranks = range(host * lw, min((host + 1) * lw, world))
    return sorted({r // mesh.n_model for r in ranks})
