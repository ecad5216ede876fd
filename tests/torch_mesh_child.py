"""One rank of the port's mesh tests on the CPU (gloo), started by
tests/test_torch_sharding.py and tests/test_torch_multihost.py.

    python torch_mesh_child.py <sharding|multihost> <workdir> <rank> <world>

Reads ``<workdir>/inputs.pkl`` (numpy only: the JAX initial train state of
tests/test_sharding.py's scene, targets, cameras, split draws), joins the
process group (``sharding``: a FileStore under ``<workdir>``; ``multihost``:
``multihost.initialize_from_env`` from torchrun's variables, which the
parent sets), runs every case of its mode and writes this rank's results
(numpy) to ``<workdir>/out<rank>.pkl``.  Imports neither JAX nor the JAX
package.
"""

import dataclasses
import datetime
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gs_deformable_tpu_torch import config, convert, training  # noqa: E402
from gs_deformable_tpu_torch.parallel import multihost, sharding  # noqa: E402
from gs_deformable_tpu_torch.renderer import CameraArrays  # noqa: E402

W, H = 48, 64  # tests/test_sharding.py: 3 x 4 tiles, one tile row a band at n_model 4
W5, H5 = 48, 80  # 5 tile rows over n_model 4
TIMEOUT_S = 300
VARIANTS = {
    "packed": dict(composite_mode="packed", sub_chunk=4),
    "batch": dict(composite_mode="batch"),
    "no_cull": dict(tile_cull=False),
    "scatter_fill": dict(fill_mode="scatter"),
}


def make_cfg(raster=None, **model):
    """tests/test_sharding.py:make_cfg in the port's config."""
    return config.Config(
        model=config.ModelConfig(sh_degree=1, **model),
        deform=config.DeformConfig(depth=2, width=32, warmup_iters=2, sh_coeffs=4,
                                   compute_dtype="float32"),
        raster=config.RasterizeConfig(instance_capacity=2048, chunk=8, **(raster or {})))


def initial_state(inp, cfg, **gauss):
    init = inp["init"]
    arrays = dict(init["gaussians"], **gauss)
    return convert.train_state_from_jax_numpy(arrays, init["deform"], init["adam"], cfg,
                                              device="cpu", latent_params=init["latent"])


def camera(inp, t):
    return CameraArrays.from_numpy(np.array(inp["view"]), np.array(inp["full"]), np.zeros(3), t,
                                   device="cpu")


def step_kw(width=W, height=H):
    tan = float(np.tan(0.4))
    return dict(width=width, height=height, tan_fovx=tan, tan_fovy=tan, active_sh_degree=0,
                spatial_lr_scale=1.0)


def record(ts, mesh, metrics=None):
    """This rank's view: the gathered state, its own slice's row count and
    per-gaussian bytes, the metrics."""
    full = sharding.gather_train_state(ts, mesh)
    g = ts.gaussians
    nbytes = sum(t.numel() * t.element_size() for t in
                 [getattr(g, f.name) for f in dataclasses.fields(g)]
                 + [ts.adam.mu[k] for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                                            "rotation")]
                 + [ts.adam.nu[k] for k in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                                            "rotation")])
    out = {"state": convert.train_state_to_numpy(full), "rows": g.capacity, "bytes": nbytes,
           "local": convert.train_state_to_numpy(ts)}
    if metrics is not None:
        out["metrics"] = {k: np.asarray(v) for k, v in metrics.items()}
    return out


def run_step(inp, mesh, cfg, cam_times, gts, width=W, height=H, it=10):
    ts = sharding.shard_train_state(initial_state(inp, cfg), mesh)
    step = sharding.make_sharded_train_step(cfg, mesh, **step_kw(width, height))
    d = mesh.data_index
    ts, m = step(ts, camera(inp, cam_times[d]), torch.from_numpy(gts[d]), torch.zeros(3), it)
    return record(ts, mesh, m)


def sharding_cases(inp):
    res = {}
    m14 = sharding.make_mesh(1, 4, "cpu")
    m22 = sharding.make_mesh(2, 2, "cpu")
    cfg = make_cfg()
    res["step_1x4"] = run_step(inp, m14, cfg, [0.3], inp["gt1"][None])
    res["step_2x2"] = run_step(inp, m22, cfg, [0.1, 0.7], inp["gt2"])
    res["grid5"] = run_step(inp, m14, cfg, [0.3], inp["gt5"][None], W5, H5)
    for name, over in VARIANTS.items():
        res[name] = run_step(inp, m14, make_cfg(over), [0.3], inp["gt1"][None])
    res["gate"] = run_step(inp, m14, make_cfg(use_opacity_mask=True), [0.3], inp["gt1"][None])

    # Chunk against per-step: 3 steps of a 4-slot chunk; the pad slot
    # (time 99) must never run.
    times = [0.1, 0.45, 0.8, 99.0]
    gts = torch.from_numpy(inp["gts_chunk"])
    d = m22.data_index
    ts = sharding.shard_train_state(initial_state(inp, cfg), m22)
    step = sharding.make_sharded_train_step(cfg, m22, **step_kw())
    for k in range(3):
        ts, m = step(ts, camera(inp, times[k] + 0.05 * d), gts[k, d], torch.zeros(3), 10 + k)
    res["per_step"] = record(ts, m22, m)
    ts = sharding.shard_train_state(initial_state(inp, cfg), m22)
    chunk = sharding.make_sharded_chunk_step(cfg, m22, chunk_max=4, **step_kw())
    cams = sharding.batch_cameras(
        [CameraArrays.from_numpy(inp["view"], inp["full"], np.zeros(3), t + 0.05 * d,
                                 device="cpu") for t in times], device="cpu")
    losses = []
    ts, m = chunk(ts, cams, gts[:, d], torch.zeros(3), 10, 3, losses)
    res["chunk"] = record(ts, m22, m)
    res["chunk"]["losses"] = [float(x) for x in losses]

    # Densify on fabricated statistics with JAX's per-shard draws, then the
    # opacity reset; and once more drawing from the ranks' own generators.
    gauss = dict(xyz_gradient_accum=inp["accum"], denom=np.ones_like(inp["accum"]))
    dens = sharding.make_sharded_densify_step(cfg, m22, extent=3.0, use_screen_prune=False)
    reset = sharding.make_sharded_opacity_reset(cfg, m22)
    ts = sharding.shard_train_state(initial_state(inp, cfg, **gauss), m22)
    normals = torch.from_numpy(inp["normals"][m22.model_index])
    ts, info = dens(ts, 2e-4, 0.005, normals)
    res["densify"] = record(ts, m22)
    res["densify"]["info"] = {k: int(v) for k, v in info.items()}
    res["reset"] = record(reset(ts), m22)
    ts = sharding.shard_train_state(initial_state(inp, cfg, **gauss), m22)
    ts, info = dens(ts, 2e-4, 0.005)
    res["densify_own_draws"] = record(ts, m22)
    res["densify_own_draws"]["info"] = {k: int(v) for k, v in info.items()}

    # Growth and re-shard, as the trainer does it.
    ts = sharding.shard_train_state(initial_state(inp, cfg), m14)
    grown = training.grow_capacity(sharding.gather_train_state(ts, m14), 128)
    res["grow"] = record(sharding.shard_train_state(grown, m14), m14)
    return res


def multihost_cases(inp):
    """A 2x2 run fed only this host's data rows against the same run fed
    every row; the mesh and host layout."""
    mesh = multihost.global_mesh(2, 2, device="cpu")
    cfg = make_cfg()
    res = {"rows": multihost.local_data_indices(mesh), "rank": mesh.rank,
           "coords": (mesh.data_index, mesh.model_index),
           "backend": dist.get_backend(), "world": dist.get_world_size()}
    step = sharding.make_sharded_train_step(cfg, mesh, **step_kw())
    times = np.asarray([0.1, 0.7], np.float32)
    for feed in ("local", "all"):
        rows = res["rows"] if feed == "local" else [0, 1]
        gts = {r: torch.from_numpy(inp["gt2"][r].copy()) for r in rows}  # what this host holds
        cams = {r: camera(inp, float(times[r])) for r in rows}
        ts = sharding.shard_train_state(initial_state(inp, cfg), mesh)
        for it in range(1, 4):
            ts, m = step(ts, cams[mesh.data_index], gts[mesh.data_index], torch.zeros(3), 9 + it)
        res[feed] = record(ts, mesh, m)
        res[feed]["held_rows"] = sorted(gts)
    return res


def main():
    mode, work, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    torch.set_num_threads(1)
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    if mode == "sharding":
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        res = sharding_cases(inp)
    else:
        multihost.initialize_from_env(device="cpu", timeout_s=TIMEOUT_S)
        res = multihost_cases(inp)
    with open(os.path.join(work, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
