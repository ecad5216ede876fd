"""Port parity: point-cloud and model PLY, net .npz and checkpoints.

Every file goes both ways: the JAX package writes and the port reads, and
the port writes and the JAX package reads, bitwise on every field the two
states share.  Given the same data both packages write the same PLY bytes
and the same .npz keys.  A checkpoint of the port has no ``.key`` and no
``.latent`` leaves: loaded into a JAX template those keep the template's
values, and the port ignores them in a JAX file.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.io import checkpoint as jckpt
from gs_deformable_tpu.io import model_ply as jmodel_ply
from gs_deformable_tpu.io import ply as jply
from gs_deformable_tpu.models import gaussians as jgaussians
from gs_deformable_tpu_torch import config, convert
from gs_deformable_tpu_torch.io import checkpoint, model_ply, ply
from gs_deformable_tpu_torch.models.deform import OffsetNet

N, CAP = 30, 48


def read_bytes(p):
    with open(p, "rb") as f:
        return f.read()


def configs(mod):
    return mod.Config(model=mod.ModelConfig(sh_degree=2),
                      deform=mod.DeformConfig(depth=2, width=16, sh_coeffs=9))


def jax_state(seed=0):
    """A JAX TrainState with every field and moment set to seeded values."""
    rng = np.random.default_rng(seed)
    st = jgaussians.init_from_points(rng.normal(size=(N, 3)).astype(np.float32),
                                     rng.uniform(size=(N, 3)).astype(np.float32),
                                     capacity=CAP, sh_degree=2)
    ts = jtraining.init_train_state(st, seed, configs(jconfig))

    def rand(x):
        if x.dtype == jnp.bool_:
            return jnp.asarray(rng.uniform(size=x.shape) < 0.7)
        if jnp.issubdtype(x.dtype, jnp.integer):
            return x
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    ts = ts.replace(gaussians=jax.tree_util.tree_map(rand, ts.gaussians),
                    deform=jax.tree_util.tree_map(rand, ts.deform),
                    adam=ts.adam.replace(mu=jax.tree_util.tree_map(rand, ts.adam.mu),
                                         nu=jax.tree_util.tree_map(rand, ts.adam.nu),
                                         step=jnp.asarray(17, jnp.int32)))
    return jax.tree_util.tree_map(np.asarray, ts)


def port_state(np_ts, seed=0):
    g = np_ts.gaussians
    arrays = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    adam = {"mu": np_ts.adam.mu, "nu": np_ts.adam.nu, "step": np_ts.adam.step}
    return convert.train_state_from_jax_numpy(arrays, np_ts.deform, adam, configs(config),
                                              device="cpu", seed=seed)


def assert_shared_equal(np_ts, ts):
    """Every field the two TrainStates share, bitwise, dtypes included."""
    out = convert.train_state_to_numpy(ts)
    for name, a in out["gaussians"].items():
        b = getattr(np_ts.gaussians, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    pairs = [(out["deform"], np_ts.deform), (out["adam"]["mu"], np_ts.adam.mu),
             (out["adam"]["nu"], np_ts.adam.nu)]
    for ours, theirs in pairs:
        for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(a, b)
    assert out["adam"]["step"] == int(np_ts.adam.step)
    assert ts.adam.step.dtype == torch.int32


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_point_cloud_ply(direction, tmp_path):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(100, 3))
    rgb = rng.uniform(0, 255, (100, 3))
    src, dst = (jply, ply) if direction == "jax_to_port" else (ply, jply)
    p = str(tmp_path / "pc.ply")
    src.store_point_cloud(p, xyz, rgb)
    for a, b in zip(dst.fetch_point_cloud(p), jply.fetch_point_cloud(p)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    other = str(tmp_path / "other.ply")
    dst.store_point_cloud(other, xyz, rgb)
    assert read_bytes(p) == read_bytes(other)
    np.testing.assert_array_equal(ply.fetch_point_cloud(p)[0], xyz.astype(np.float32))


def test_write_ply_dtypes(tmp_path):
    rng = np.random.default_rng(2)
    names = ["a", "b", "c", "d", "e"]
    cols = [rng.normal(size=7).astype(np.float32), rng.normal(size=7),
            rng.integers(0, 255, 7).astype(np.uint8), rng.integers(-9, 9, 7).astype(np.int32),
            rng.integers(0, 9, 7).astype(np.uint32)]
    jply.write_ply(str(tmp_path / "j.ply"), names, cols)
    ply.write_ply(str(tmp_path / "t.ply"), names, cols)
    assert read_bytes(str(tmp_path / "j.ply")) == read_bytes(str(tmp_path / "t.ply"))
    for name, col in zip(names, cols):
        np.testing.assert_array_equal(ply.read_ply(str(tmp_path / "t.ply"))[name], col)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_ply_and_nets(direction, tmp_path):
    np_ts = jax_state()
    ts = port_state(np_ts)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmodel_ply.save_ply(jdir, jax.tree_util.tree_map(jnp.asarray, np_ts.gaussians),
                        nets={"offset_model": np_ts.deform})
    model_ply.save_ply(tdir, ts.gaussians, nets={"offset_model": ts.net.param_tree()})
    assert read_bytes(os.path.join(jdir, "point_cloud.ply")) == \
        read_bytes(os.path.join(tdir, "point_cloud.ply"))
    with np.load(os.path.join(jdir, "offset_model.npz")) as a, \
            np.load(os.path.join(tdir, "offset_model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
    src = jdir if direction == "jax_to_port" else tdir
    ply_path = os.path.join(src, "point_cloud.ply")
    a, deg_a = model_ply.load_ply(ply_path, 64, 2, device="cpu")
    b, deg_b = jmodel_ply.load_ply(ply_path, 64, 2)
    assert deg_a == deg_b == 2
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(), np.asarray(getattr(b, f.name)),
                                      err_msg=f.name)
    alive = np_ts.gaussians.alive
    for f in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation"):
        np.testing.assert_array_equal(getattr(a, f).numpy()[:alive.sum()],
                                      getattr(np_ts.gaussians, f)[alive], err_msg=f)

    net_path = os.path.join(src, "offset_model.npz")
    mine = model_ply.load_net(net_path, configs(config).deform, device="cpu",
                              kind=OffsetNet)
    theirs = jmodel_ply.load_net(net_path, np_ts.deform)
    for x, y, z in zip(jax.tree_util.tree_leaves(mine.numpy_params()),
                       jax.tree_util.tree_leaves(theirs),
                       jax.tree_util.tree_leaves(np_ts.deform)):
        np.testing.assert_array_equal(x, np.asarray(y))
        np.testing.assert_array_equal(x, z)


def test_save_ply_xyz_override(tmp_path):
    np_ts = jax_state(3)
    ts = port_state(np_ts)
    xyz = np.random.default_rng(4).normal(size=(CAP, 3)).astype(np.float32)
    jmodel_ply.save_ply(str(tmp_path), jax.tree_util.tree_map(jnp.asarray, np_ts.gaussians),
                        xyz_override=jnp.asarray(xyz), filename="j.ply")
    model_ply.save_ply(str(tmp_path), ts.gaussians, xyz_override=torch.from_numpy(xyz),
                       filename="t.ply")
    assert read_bytes(str(tmp_path / "j.ply")) == read_bytes(str(tmp_path / "t.ply"))


def test_checkpoint_jax_to_port(tmp_path):
    np_ts = jax_state(5)
    p = str(tmp_path / "ck" / "chkpnt_30.npz")
    jckpt.save_checkpoint(p, jax.tree_util.tree_map(jnp.asarray, np_ts), 30)
    template = port_state(jax_state(6), seed=11)
    ts, it = checkpoint.load_checkpoint(p, template)
    assert it == 30
    assert_shared_equal(np_ts, ts)
    # no generator in a JAX file: the template's state carries over
    assert torch.equal(ts.generator.get_state(), template.generator.get_state())
    assert ts.generator is not template.generator


def test_checkpoint_port_to_jax(tmp_path):
    np_ts = jax_state(7)
    ts = port_state(np_ts, seed=3)
    p = str(tmp_path / "chkpnt_40.npz")
    checkpoint.save_checkpoint(p, ts, 40)
    keys = set(np.load(p).files)
    assert ".key" not in keys and not any(k.startswith(".latent") for k in keys)
    assert ".generator/cpu" in keys

    template = jax.tree_util.tree_map(jnp.asarray, jax_state(8))
    loaded, it = jckpt.load_checkpoint(p, template)
    assert it == 40
    assert_shared_equal(jax.tree_util.tree_map(np.asarray, loaded), ts)
    for a, b in zip(jax.tree_util.tree_leaves(loaded.latent),
                    jax.tree_util.tree_leaves(template.latent)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(loaded.key), np.asarray(template.key))


def test_checkpoint_port_round_trip(tmp_path):
    """The generator resumes its stream; a wrong shape raises."""
    ts = port_state(jax_state(9), seed=5)
    torch.randn(4, generator=ts.generator)
    p = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(p, ts, 12)
    ts2, it = checkpoint.load_checkpoint(p, port_state(jax_state(10), seed=99))
    assert it == 12
    assert_shared_equal(jax.tree_util.tree_map(np.asarray, jax_state(9)), ts2)
    assert torch.equal(torch.randn(6, generator=ts2.generator),
                       torch.randn(6, generator=ts.generator))
    assert isinstance(ts2.net, OffsetNet)

    small = jax_state(9)
    small = small.replace(gaussians=jax.tree_util.tree_map(lambda x: x[:32], small.gaussians))
    arrays = {f.name: getattr(small.gaussians, f.name)
              for f in dataclasses.fields(small.gaussians)}
    bad = port_state(jax_state(9))
    bad = dataclasses.replace(bad, gaussians=type(bad.gaussians).from_numpy(arrays, device="cpu"))
    with pytest.raises(ValueError, match="template"):
        checkpoint.load_checkpoint(p, bad)
