"""Port parity: init, densify/prune and the opacity reset (one case for each
test of tests/test_gaussians.py:18-184 and tests/test_train_step.py:69, on
the same states; capacity growth and the batched eval are in
tests/test_torch_eval.py).

The JAX functions draw the split children's normals from their PRNG key;
the port takes that draw as numpy.  Bars:

- ``alive``, the ``DensifyInfo`` counts, the Adam moments (copied or
  zeroed) and the reset statistics: equal;
- every row that is a copy (survivors, clones, the other groups of split
  children): bitwise;
- split children's xyz (``x + R (n * s)``) and scaling (``log(s / 1.6)``):
  rtol 1e-6 / atol 1e-6;
- ``init_from_points``: the squared scales at the k-NN bar (rtol 1e-4,
  atol 1e-6 x max|x|^2, tests/test_torch_knn.py), opacity and DC colour at
  rtol 1e-6; the reset opacity at rtol 1e-6 (exp and log round apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.models import gaussians as jgaussians
from gs_deformable_tpu_torch import config, convert, training
from gs_deformable_tpu_torch.models import gaussians as tgaussians
from gs_deformable_tpu_torch.models.gaussians import GaussianState

GROUPS = jgaussians.PARAM_GROUPS
KW = dict(grad_threshold=0.5, min_opacity=0.005, extent=1.0, percent_dense=0.01)


def jstate(rng, n, cap, sh_degree=3, **fields):
    st = jgaussians.init_from_points(rng.normal(size=(n, 3)).astype(np.float32),
                                     rng.uniform(size=(n, 3)).astype(np.float32),
                                     capacity=cap, sh_degree=sh_degree)
    return st.replace(**{k: jnp.asarray(v) for k, v in fields.items()})


def to_port(st):
    return GaussianState.from_numpy(
        {f.name: np.asarray(getattr(st, f.name)) for f in dataclasses.fields(GaussianState)},
        device="cpu")


def t_tree(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def assert_states(port: GaussianState, ref, before=None):
    """``port`` against the JAX state ``ref``; rows of xyz and scaling that
    match no row of ``before`` are split children, held at 1e-6."""
    for f in dataclasses.fields(GaussianState):
        got = getattr(port, f.name).numpy()
        want = np.asarray(getattr(ref, f.name))
        assert got.dtype == want.dtype, f.name
        if f.name in ("xyz", "scaling") and before is not None:
            old = {r.tobytes() for r in np.asarray(getattr(before, f.name))}
            child = np.array([r.tobytes() not in old for r in want])
            np.testing.assert_array_equal(got[~child], want[~child], err_msg=f.name)
            np.testing.assert_allclose(got[child], want[child], rtol=1e-6, atol=1e-6,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f.name)


def assert_moments(port, ref, groups=GROUPS):
    for k in groups:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)


def densify_case(name, rng):
    """(JAX state, mu, nu, kwargs) of each test_gaussians.py densify case,
    and a mixed case that takes every branch at once."""
    kw = dict(KW, use_screen_prune=False)
    if name == "clone_and_split":  # test_gaussians.py:55
        st = jstate(rng, 4, 32)
        scal = np.full((32, 3), np.log(0.001), np.float32)
        scal[1] = np.log(10.0)
        accum = np.zeros((32, 1), np.float32)
        accum[:2] = 1.0
        denom = np.zeros((32, 1), np.float32)
        denom[:4] = 1.0
        st = st.replace(scaling=jnp.asarray(scal), xyz_gradient_accum=jnp.asarray(accum),
                        denom=jnp.asarray(denom))
    elif name == "prune_low_opacity":  # :95
        st = jstate(rng, 4, 8)
        st = st.replace(opacity=st.opacity.at[2].set(-10.0))
    elif name == "capacity_overflow":  # :110, 6 clones wanted, 2 free slots
        st = jstate(rng, 6, 8)
        st = st.replace(scaling=jnp.full_like(st.scaling, np.log(0.001)),
                        xyz_gradient_accum=jnp.ones((8, 1)), denom=jnp.ones((8, 1)))
    elif name == "split_overflow":  # 3 splits want 6 slots, 5 free: one child drops
        st = jstate(rng, 3, 8)
        st = st.replace(scaling=jnp.full_like(st.scaling, np.log(10.0)),
                        xyz_gradient_accum=jnp.ones((8, 1)), denom=jnp.ones((8, 1)))
    elif name == "screen_prune":  # :126
        st = jstate(rng, 4, 8)
        st = st.replace(scaling=st.scaling.at[3].set(np.log(100.0)))
        kw["use_screen_prune"] = True
    elif name == "offset_gated":  # :161
        st = jstate(rng, 4, 16)
        accum = np.zeros((16, 1), np.float32)
        accum[:4] = 1.0
        st = st.replace(scaling=jnp.full_like(st.scaling, np.log(0.001)),
                        xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(accum))
        kw["offset_mask"] = jnp.asarray([True] + [False] * 15)
    else:  # mixed: interleaved dead rows, both regimes, prunes, overflow
        n, cap = 60, 96
        st = jstate(rng, n, cap)
        alive = rng.uniform(size=cap) < 0.55
        rot = rng.normal(size=(cap, 4)).astype(np.float32)
        st = st.replace(
            alive=jnp.asarray(alive), rotation=jnp.asarray(rot),
            scaling=jnp.asarray(np.log(rng.uniform(0.002, 0.03, (cap, 3))).astype(np.float32)),
            opacity=jnp.asarray(rng.normal(-2, 2.5, (cap, 1)).astype(np.float32)),
            xyz_gradient_accum=jnp.asarray(rng.uniform(0, 2, (cap, 1)).astype(np.float32)),
            denom=jnp.asarray(rng.integers(0, 3, (cap, 1)).astype(np.float32)))
        kw.update(use_screen_prune=True, extent=0.2, percent_dense=0.1)
    p = st.params()
    mu = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in p.items()}
    nu = {k: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32)) for k, v in p.items()}
    return st, mu, nu, kw


CASES = ["clone_and_split", "prune_low_opacity", "capacity_overflow", "split_overflow",
         "screen_prune", "offset_gated", "mixed"]


@pytest.mark.parametrize("case", CASES)
def test_densify_and_prune(case):
    rng = np.random.default_rng(CASES.index(case))
    st, mu, nu, kw = densify_case(case, rng)
    key = jax.random.PRNGKey(CASES.index(case))
    ref, rmu, rnu, rinfo = jgaussians.densify_and_prune(st, mu, nu, key, **kw)
    normals = np.array(jax.random.normal(key, (st.capacity, 2, 3)))
    tkw = dict(kw)
    if "offset_mask" in kw:
        tkw["offset_mask"] = torch.from_numpy(np.array(kw["offset_mask"]))
    out, tmu, tnu, info = tgaussians.densify_and_prune(
        to_port(st), t_tree(mu), t_tree(nu), torch.from_numpy(normals), **tkw)
    assert {k: int(v) for k, v in info._asdict().items()} == \
        {k: int(v) for k, v in rinfo._asdict().items()}
    assert_states(out, ref, before=st)
    assert_moments(tmu, rmu)
    assert_moments(tnu, rnu)
    if case == "capacity_overflow":
        assert int(info.n_dropped) == 4 and int(info.n_alive) == 8
    if case == "clone_and_split":
        assert int(info.n_cloned) == 1 and int(info.n_split) == 1
    if case == "mixed":
        assert min(int(v) for v in info) > 0  # every count moved


def test_init_from_points():
    """test_gaussians.py:18 on JAX's and the port's init, plus a wide cloud."""
    rng = np.random.default_rng(0)
    for n, cap, deg, spread in ((6, 16, 3, 1.0), (200, 256, 1, 40.0)):
        pts = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
        cols = rng.uniform(size=(n, 3)).astype(np.float32)
        ref = jgaussians.init_from_points(pts, cols, capacity=cap, sh_degree=deg)
        st = tgaussians.init_from_points(pts, cols, capacity=cap, sh_degree=deg, device="cpu")
        for f in dataclasses.fields(GaussianState):
            got, want = getattr(st, f.name).numpy(), np.asarray(getattr(ref, f.name))
            assert got.shape == want.shape and got.dtype == want.dtype, f.name
            if f.name == "scaling":
                np.testing.assert_allclose(np.exp(2.0 * got.astype(np.float64)),
                                           np.exp(2.0 * want.astype(np.float64)), rtol=1e-4,
                                           atol=1e-6 * float(np.abs(pts).max()) ** 2)
                assert (got[:, 0] == got[:, 1]).all() and (got[:, 1] == got[:, 2]).all()
            elif f.name in ("opacity", "f_dc"):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f.name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f.name)
    with pytest.raises(ValueError, match="capacity"):
        tgaussians.init_from_points(pts, cols, capacity=n - 1, sh_degree=1, device="cpu")


def test_reset_opacity():
    """test_gaussians.py:140."""
    rng = np.random.default_rng(1)
    st = jstate(rng, 6, 16, opacity=rng.normal(0, 3, (16, 1)).astype(np.float32))
    p = st.params()
    mu = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)) for k, v in p.items()}
    ref, rmu, rnu = jgaussians.reset_opacity(st, mu, mu)
    out, tmu, tnu = tgaussians.reset_opacity(to_port(st), t_tree(mu), t_tree(mu))
    np.testing.assert_allclose(out.opacity.numpy(), np.asarray(ref.opacity), rtol=1e-6)
    assert float(out.get_opacity().max()) <= 0.01 + 1e-6
    assert_moments(tmu, rmu)
    assert_moments(tnu, rnu)
    for f in dataclasses.fields(GaussianState):
        if f.name != "opacity":
            np.testing.assert_array_equal(getattr(out, f.name).numpy(),
                                          np.asarray(getattr(ref, f.name)))


def test_stats_accumulation():
    """test_gaussians.py:149."""
    rng = np.random.default_rng(2)
    st = jstate(rng, 4, 8)
    grad = rng.normal(size=(8, 2)).astype(np.float32)
    vis = np.array([True, False, True, False, False, True, False, False])
    radii = np.array([5, 0, 9, 0, 0, 3, 0, 0], np.int32)
    ref = jgaussians.add_densification_stats(st, jnp.asarray(grad), jnp.asarray(vis),
                                             jnp.asarray(radii))
    out = tgaussians.add_densification_stats(to_port(st), torch.from_numpy(grad),
                                             torch.from_numpy(vis), torch.from_numpy(radii))
    assert_states(out, ref)


def tiny_configs(gate=0.0):
    """tests/test_train_step.py:tiny_config in both packages."""
    def make(mod):
        return mod.Config(
            model=mod.ModelConfig(sh_degree=1),
            deform=mod.DeformConfig(depth=2, width=32, warmup_iters=5, sh_coeffs=4,
                                    compute_dtype="float32"),
            raster=mod.RasterizeConfig(instance_capacity=2048, chunk=8),
            opt=mod.OptimizationConfig(densify_offset_gate=gate))
    return make(jconfig), make(config)


def train_states(jcfg, cfg, st):
    """The JAX TrainState of ``st`` (seed 0) as numpy, and the port's copy."""
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(st, seed=0, cfg=jcfg))
    g = init.gaussians
    arrays = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    adam = {"mu": init.adam.mu, "nu": init.adam.nu, "step": init.adam.step}
    return init, convert.train_state_from_jax_numpy(arrays, init.deform, adam, cfg,
                                                    device="cpu")


def jax_draw(np_ts):
    """The normals JAX's make_densify_step draws from ``ts.key``."""
    _, sub = jax.random.split(jnp.asarray(np_ts.key))
    return torch.from_numpy(np.array(
        jax.random.normal(sub, (np_ts.gaussians.xyz.shape[0], 2, 3))))


def assert_train_states(ts, ref, before):
    assert_states(ts.gaussians, ref.gaussians, before=before.gaussians)
    assert_moments(ts.adam.mu, ref.adam.mu)
    assert_moments(ts.adam.nu, ref.adam.nu)
    assert int(ts.adam.step) == int(ref.adam.step)


@pytest.mark.parametrize("gate", [0.0, 0.3], ids=["ungated", "gated"])
def test_make_densify_step_offset_gate(gate):
    """test_gaussians.py:184: densify_offset_gate limits clone/split to rows
    whose latest offset norm reaches it."""
    rng = np.random.default_rng(3)
    n, cap = 24, 64
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    st = jgaussians.init_from_points(pts, cols, capacity=cap, sh_degree=1)
    accum = np.zeros((cap, 1), np.float32)
    accum[:n] = 1.0
    offs = np.zeros(cap, np.float32)
    offs[:12] = 0.5
    st = st.replace(xyz_gradient_accum=jnp.asarray(accum), denom=jnp.ones((cap, 1)),
                    last_offset_norm=jnp.asarray(offs))
    jcfg, cfg = tiny_configs(gate)
    init, ts = train_states(jcfg, cfg, st)
    dens = jtraining.make_densify_step(jcfg, extent=3.0, use_screen_prune=False)
    ref, rinfo = dens(jax.tree_util.tree_map(jnp.array, init), jnp.float32(1e-4),
                      jnp.float32(0.005))
    run = training.make_densify_step(cfg, extent=3.0, use_screen_prune=False, device="cpu")
    out, info = run(ts, 1e-4, 0.005, normals=jax_draw(init))
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in rinfo.items()}
    assert info["n_cloned"] + info["n_split"] == (12 if gate else n)
    assert_train_states(out, jax.tree_util.tree_map(np.asarray, ref), init)


def setup_scene(rng, n=40, cap=64):
    """tests/test_train_step.py:make_setup."""
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                    rng.uniform(3, 6, n)], -1).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    return jgaussians.init_from_points(pts, cols, capacity=cap, sh_degree=1)


def test_densify_and_reset_steps():
    """test_train_step.py:69: make_densify_step then make_opacity_reset."""
    rng = np.random.default_rng(0)
    st = setup_scene(rng)
    accum = np.zeros((64, 1), np.float32)
    accum[:10] = 1.0
    denom = np.zeros((64, 1), np.float32)
    denom[:40] = 1.0
    st = st.replace(xyz_gradient_accum=jnp.asarray(accum), denom=jnp.asarray(denom))
    jcfg, cfg = tiny_configs()
    init, ts = train_states(jcfg, cfg, st)
    ref, rinfo = jtraining.make_densify_step(jcfg, extent=5.0, use_screen_prune=False)(
        jax.tree_util.tree_map(jnp.array, init), jnp.float32(0.5), jnp.float32(0.005))
    ref = jtraining.make_opacity_reset(jcfg)(ref)
    out, info = training.make_densify_step(cfg, extent=5.0, use_screen_prune=False,
                                           device="cpu")(ts, 0.5, 0.005,
                                                         normals=jax_draw(init))
    assert int(info["n_cloned"]) + int(info["n_split"]) > 0
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in rinfo.items()}
    out = training.make_opacity_reset(cfg)(out)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    np.testing.assert_allclose(out.gaussians.opacity.numpy(), ref.gaussians.opacity, rtol=1e-6)
    out = dataclasses.replace(out, gaussians=dataclasses.replace(
        out.gaussians, opacity=torch.from_numpy(ref.gaussians.opacity)))
    assert_train_states(out, ref, init)
    assert float(out.adam.mu["opacity"].abs().max()) == 0.0


def test_densify_step_draws_from_generator():
    """Without ``normals`` the step draws from ``ts.generator``: the same seed
    gives the same children, and the generator moves on."""
    rng = np.random.default_rng(4)
    st = jstate(rng, 8, 32, scaling=np.full((32, 3), np.log(10.0), np.float32),
                xyz_gradient_accum=np.ones((32, 1), np.float32),
                denom=np.ones((32, 1), np.float32))
    jcfg, cfg = tiny_configs()
    run = training.make_densify_step(cfg, extent=1.0, use_screen_prune=False, device="cpu")
    outs = []
    for _ in range(2):
        _, ts = train_states(jcfg, cfg, st)
        draw = torch.randn((32, 2, 3), generator=training.make_generator(0, "cpu"))
        out, info = run(ts, 0.5, 0.005)
        outs.append(out)
        assert int(info["n_split"]) == 8
    want, _ = run(train_states(jcfg, cfg, st)[1], 0.5, 0.005, normals=draw)
    assert torch.equal(outs[0].gaussians.xyz, outs[1].gaussians.xyz)
    assert torch.equal(outs[0].gaussians.xyz, want.gaussians.xyz)
    assert not torch.equal(torch.randn(3, generator=outs[0].generator),
                           torch.randn(3, generator=training.make_generator(0, "cpu")))
