"""The port's mesh (``parallel/sharding.py``) on the CPU: 4 gloo ranks against
JAX's sharded step on its 8 virtual CPU devices.

tests/test_sharding.py's scene and config (48x64, 3 x 4 tiles, 40 gaussians
in capacity 64, SH degree 1, a 2x32 offset net in the fp32 tier: the bf16
tier trips these bars through Adam's first rsqrt).  The JAX initial train
state goes to both sides as numpy; both shard it with the interleave, so
JAX's global row order is the port's gathered order.  One group of 4 ranks
(``tests/torch_mesh_child.py``, a FileStore, one thread each) runs every
case once for the module while JAX compiles its steps.

Bars (tests/test_torch_train_step.py): loss and the metrics rtol 1e-5;
gradients, read from Adam's first moments (``mu = 0.1 g``, ``|g| =
sqrt(nu / 0.001)``), rtol 1e-3 / atol 5e-5 x the leaf's max |g|, also
for ``xyz_gradient_accum``; updated parameters rtol 1e-6 / atol 1e-5 x lr
where the gradient is firm, else within 2 lr; ``denom`` and ``max_radii2d``
exact.  The sharded loss sums masked band terms where the single-device
step takes a mean, so the two agree only to rounding: the same bars hold
the port's mesh to the port's single-device step (grid_y 5 over 4 bands,
the composite / cull / fill variants, the opacity gate).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sharding import H, W, make_cfg, make_setup

from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.parallel import sharding as jsharding
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu_torch import convert, training
from gs_deformable_tpu_torch.parallel import sharding

import torch_mesh_child as child

HERE = os.path.dirname(os.path.abspath(__file__))
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
RANKS = 4
TAN = float(np.tan(0.4))


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def state_dict(ts):
    """A JAX TrainState as the numpy layout of ``convert``."""
    g = ts.gaussians
    return {"gaussians": {f: np.asarray(getattr(g, f)) for f in
                          ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "alive",
                           "max_radii2d", "xyz_gradient_accum", "denom", "last_offset_norm")},
            "deform": np_tree(ts.deform), "latent": np_tree(ts.latent),
            "adam": {"mu": np_tree(ts.adam.mu), "nu": np_tree(ts.adam.nu),
                     "step": int(ts.adam.step)}}


def spawn(mode, work, env=None):
    return [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mesh_child.py"), mode,
                              str(work), str(r), str(RANKS)],
                             env=dict(os.environ, **(env(r) if env else {})),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(RANKS)]


def collect(procs, work, timeout=600):
    outs = []
    for p in procs:
        text, _ = p.communicate(timeout=timeout)
        outs.append(text)
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-6000:]}"
    res = []
    for r in range(RANKS):
        with open(os.path.join(work, f"out{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def make_inputs():
    jcfg = make_cfg()
    state, cam, _ = make_setup()
    ts0 = jtraining.init_train_state(state, seed=0, cfg=jcfg)
    rng = np.random.default_rng(7)
    accum = np.zeros((64, 1), np.float32)
    accum[5:15] = 5e-3
    # JAX's per-shard split draws (sharding.py:544-546, gaussians.py:291).
    _, sub = jax.random.split(ts0.key)
    normals = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(sub, m), (32, 2, 3)))
                        for m in range(2)])
    return ts0, cam, {
        "init": state_dict(ts0), "view": np.asarray(cam.world_view),
        "full": np.asarray(cam.full_proj),
        "gt1": rng.uniform(0, 1, (3, H, W)).astype(np.float32),
        "gt2": rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32),
        "gt5": rng.uniform(0, 1, (3, child.H5, child.W5)).astype(np.float32),
        "gts_chunk": rng.uniform(0, 1, (4, 2, 3, H, W)).astype(np.float32),
        "accum": accum, "normals": normals}


def jax_runs(ts0, cam, inp):
    """JAX's sharded 1x4 and 2x2 steps, sharded densify + reset and growth."""
    jcfg = make_cfg()
    fresh = lambda: jax.tree_util.tree_map(jnp.array, np_tree(ts0))  # noqa: E731
    kw = dict(width=W, height=H, tan_fovx=TAN, tan_fovy=TAN, active_sh_degree=0,
              spatial_lr_scale=1.0, capacity=64)
    out = {}
    for name, shape, times, gts in (("step_1x4", (1, 4), [0.3], inp["gt1"][None]),
                                    ("step_2x2", (2, 2), [0.1, 0.7], inp["gt2"])):
        mesh = jsharding.make_mesh(*shape)
        ts = jsharding.shard_train_state(fresh(), mesh)
        step = jsharding.make_sharded_train_step(jcfg, mesh, **kw)
        n = len(times)
        cam_b = JCameraArrays(jnp.stack([cam.world_view] * n), jnp.stack([cam.full_proj] * n),
                              jnp.stack([cam.camera_center] * n), jnp.asarray(times, jnp.float32))
        ts, m = step(ts, cam_b, jnp.asarray(gts), jnp.zeros(3), jnp.asarray(10))
        out[name] = {"state": state_dict(ts), "metrics": {k: np.asarray(v) for k, v in m.items()}}
    mesh = jsharding.make_mesh(2, 2)
    ts = fresh()
    ts = ts.replace(gaussians=ts.gaussians.replace(
        xyz_gradient_accum=jnp.asarray(inp["accum"]),
        denom=jnp.ones_like(ts.gaussians.denom)))
    ts = jsharding.shard_train_state(ts, mesh)
    dens = jsharding.make_sharded_densify_step(jcfg, mesh, extent=3.0, use_screen_prune=False)
    ts, info = dens(ts, jnp.float32(2e-4), jnp.float32(0.005))
    out["densify"] = {"state": state_dict(ts), "info": {k: int(v) for k, v in info.items()}}
    mesh = jsharding.make_mesh(1, 4)
    ts = jsharding.shard_train_state(fresh(), mesh)
    ts = jsharding.shard_train_state(jtraining.grow_capacity(ts, 128), mesh)
    out["grow"] = {"state": state_dict(ts)}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    ts0, cam, inp = make_inputs()
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    procs = spawn("sharding", work)
    try:
        ref = jax_runs(ts0, cam, inp)
    finally:
        port = collect(procs, work)
    return {"inp": inp, "jax": ref, "port": port}


# -- comparisons ---------------------------------------------------------------


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, np.asarray(tree))]


def assert_grad_close(got, ref, what):
    scale = np.abs(ref).max() + 1e-30
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-5 * scale, err_msg=what)


def check_step(got, ref, lrs):
    """One step's state and metrics against a reference at the train-step bars."""
    for k in ("loss", "ll1", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
    assert int(got["metrics"]["n_alive"]) == int(ref["metrics"]["n_alive"])
    gs, rs = got["state"], ref["state"]
    for moment in ("mu", "nu"):
        gl, rl = leaves(gs["adam"][moment]), leaves(rs["adam"][moment])
        assert [n for n, _ in gl] == [n for n, _ in rl]
        for (name, a), (_, b) in zip(gl, rl):
            if moment == "nu":
                a, b = np.sqrt(a / 0.001), np.sqrt(b / 0.001)
            assert_grad_close(a, b, f"{moment} {name}")
    gg, rg = gs["gaussians"], rs["gaussians"]
    np.testing.assert_array_equal(gg["denom"], rg["denom"])
    np.testing.assert_array_equal(gg["max_radii2d"], rg["max_radii2d"])
    np.testing.assert_array_equal(gg["alive"], rg["alive"])
    assert gg["denom"].sum() > 0
    assert_grad_close(gg["xyz_gradient_accum"], rg["xyz_gradient_accum"], "xyz_gradient_accum")
    np.testing.assert_allclose(gg["last_offset_norm"], rg["last_offset_norm"], rtol=1e-5,
                               atol=1e-6)
    params_g = {**{k: gg[k] for k in GROUPS}, "offset_model": gs["deform"]}
    params_r = {**{k: rg[k] for k in GROUPS}, "offset_model": rs["deform"]}
    mus = dict(leaves(rs["adam"]["mu"]))
    for (name, a), (_, b) in zip(leaves(params_g), leaves(params_r), strict=True):
        lr = lrs[name.split("/")[1].split("[")[0]]
        g = mus[name] / 0.1
        firm = np.abs(g) > 5e-5 * (np.abs(g).max() + 1e-30)
        np.testing.assert_allclose(a[firm], b[firm], rtol=1e-6, atol=1e-5 * lr, err_msg=name)
        assert np.all(np.abs(a - b) <= 2 * lr * (1 + 1e-5) + 1e-7), name


def lrs_at(it=10):
    return {k: float(v) for k, v in jtraining.learning_rates(it, make_cfg(), 1.0).items()}


def single_device(inp, cfg, gt, width=W, height=H, it=10):
    """The port's single-device step on the interleaved initial state."""
    ts = sharding.permute_gaussian_rows(child.initial_state(inp, cfg),
                                        sharding.interleave_perm(64, 4))
    step = training.make_train_step(cfg, device="cpu", **child.step_kw(width, height))
    ts, m = step(ts, child.camera(inp, 0.3), torch.from_numpy(gt), torch.zeros(3), it)
    return {"state": convert.train_state_to_numpy(ts),
            "metrics": {k: np.asarray(v) for k, v in m.items()}}


def assert_equal_trees(a, b, what):
    la, lb = leaves(a), leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb], what
    for (name, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("case", ["step_1x4", "step_2x2"])
def test_step_matches_jax_sharded(runs, case):
    check_step(runs["port"][0][case], runs["jax"][case], lrs_at())


def test_nondivisible_tile_rows_match_single_device(runs):
    """grid_y 5 over n_model 4: the last band is padded with empty rows."""
    ref = single_device(runs["inp"], child.make_cfg(), runs["inp"]["gt5"], child.W5, child.H5)
    check_step(runs["port"][0]["grid5"], ref, lrs_at())


@pytest.mark.parametrize("variant", list(child.VARIANTS))
def test_variants_match_single_device(runs, variant):
    cfg = child.make_cfg(child.VARIANTS[variant])
    check_step(runs["port"][0][variant], single_device(runs["inp"], cfg, runs["inp"]["gt1"]),
               lrs_at())


def test_opacity_gate_matches_single_device(runs):
    cfg = child.make_cfg(use_opacity_mask=True)
    got = runs["port"][0]["gate"]
    check_step(got, single_device(runs["inp"], cfg, runs["inp"]["gt1"]), lrs_at())
    plain = runs["port"][0]["step_1x4"]["metrics"]["loss"]
    assert abs(float(got["metrics"]["loss"]) - float(plain)) > 1e-6  # the gate is used


def test_chunk_matches_per_step(runs):
    a, b = runs["port"][0]["per_step"], runs["port"][0]["chunk"]
    np.testing.assert_allclose(b["metrics"]["loss"], a["metrics"]["loss"], rtol=1e-6)
    assert len(b["losses"]) == 3 and b["losses"][-1] == float(b["metrics"]["loss"])
    assert int(b["metrics"]["overflow_frames"]) == 0
    assert_equal_trees(b["state"], a["state"], "chunk vs per-step")


def test_densify_matches_jax(runs):
    got, ref = runs["port"][0]["densify"], runs["jax"]["densify"]
    assert got["info"] == {k: ref["info"][k] for k in got["info"]}
    assert got["info"]["n_split"] + got["info"]["n_cloned"] > 0
    gg, rg = got["state"]["gaussians"], ref["state"]["gaussians"]
    np.testing.assert_array_equal(gg["alive"], rg["alive"])
    moved = ~np.all(gg["xyz"] == np.asarray(runs["inp"]["init"]["gaussians"]["xyz"])[
        sharding.interleave_perm(64, 2)], axis=1)
    assert moved.any()
    for k in GROUPS:
        np.testing.assert_allclose(gg[k], rg[k], rtol=1e-6, atol=1e-6, err_msg=k)
        for moment in ("mu", "nu"):
            np.testing.assert_array_equal(got["state"]["adam"][moment][k],
                                          ref["state"]["adam"][moment][k])
    for k in ("max_radii2d", "xyz_gradient_accum", "denom", "last_offset_norm"):
        assert not gg[k].any(), k


def test_densify_own_draws(runs):
    """The ranks' own generators: the same counts (they do not depend on the
    draw), data replicas bitwise equal, other split offsets than JAX's."""
    ports = runs["port"]
    got = ports[0]["densify_own_draws"]
    assert got["info"] == ports[0]["densify"]["info"]
    assert_equal_trees(ports[2]["densify_own_draws"]["state"], got["state"], "data replicas")
    assert not np.array_equal(got["state"]["gaussians"]["xyz"],
                              ports[0]["densify"]["state"]["gaussians"]["xyz"])


def test_opacity_reset(runs):
    got = runs["port"][0]["reset"]["state"]
    before = runs["port"][0]["densify"]["state"]
    op = 1 / (1 + np.exp(-got["gaussians"]["opacity"]))
    assert (op <= 0.01 + 1e-6).all()
    ts = convert.train_state_from_jax_numpy(
        before["gaussians"], before["deform"], before["adam"], child.make_cfg(), device="cpu")
    ref = convert.train_state_to_numpy(training.make_opacity_reset(child.make_cfg())(ts))
    assert_equal_trees(got["gaussians"], ref["gaussians"], "reset")
    assert not got["adam"]["mu"]["opacity"].any()


def test_state_memory_scales_with_model_axis(runs):
    """Each rank holds capacity / n_model rows of every per-gaussian tensor
    (fields and the six groups' moments), a quarter of the bytes at n_model 4."""
    full = runs["port"][0]["step_1x4"]["state"]
    full_bytes = sum(v.nbytes for v in full["gaussians"].values()) + sum(
        full["adam"][m][k].nbytes for m in ("mu", "nu") for k in GROUPS)
    for r in range(RANKS):
        rec = runs["port"][r]["step_1x4"]
        assert rec["rows"] == 16 and rec["bytes"] * 4 == full_bytes
        for name, leaf in rec["local"]["gaussians"].items():
            assert leaf.shape[0] == 16, name
        for k in GROUPS:
            assert rec["local"]["adam"]["mu"][k].shape[0] == 16, k
        assert_equal_trees(rec["local"]["deform"], full["deform"], "the net is replicated")


def test_grow_reshard_in_jax_row_order(runs):
    got = runs["port"][0]["grow"]
    assert got["rows"] == 32
    assert_equal_trees(got["state"]["gaussians"], runs["jax"]["grow"]["state"]["gaussians"],
                       "grown gaussians")
    for m in ("mu", "nu"):
        assert_equal_trees({k: got["state"]["adam"][m][k] for k in GROUPS},
                           {k: runs["jax"]["grow"]["state"]["adam"][m][k] for k in GROUPS},
                           f"grown {m}")


@pytest.mark.parametrize("case", ["step_1x4", "step_2x2", "grid5", "gate", "chunk"])
def test_replicas_and_nets_equal_across_ranks(runs, case):
    """Every rank holds the same net bits, metrics and gathered state: model
    shards gather one state and data replicas hold equal slices."""
    recs = [runs["port"][r][case] for r in range(RANKS)]
    for r in range(1, RANKS):
        assert_equal_trees(recs[r]["state"], recs[0]["state"], f"rank {r}")
        assert_equal_trees(recs[r]["metrics"], recs[0]["metrics"], f"rank {r} metrics")


def test_mesh_refuses_a_wrong_world_size():
    with pytest.raises(ValueError, match="world size is 1"):
        sharding.make_mesh(1, 2, "cpu")
    mesh = sharding.make_mesh(1, 1, "cpu")
    assert (mesh.rank, mesh.model_group, mesh.data_group) == (0, None, None)
