"""Port parity: the SE(3) deformation, the opacity gate and a se3 + gate step.

The same seeded inputs and the JAX package's own weights (as numpy) go
through the JAX functions and the port's.  Bars, those of
tests/test_torch_train_step.py:

- the SE(3) net's moved means and the gate: rtol 1e-5 / atol 1e-6 in the
  fp32 tier; the bf16 tier rounds each activation to bf16 and a value one
  fp32 ulp apart can round to the neighbouring bf16 value, so atol 2e-3
  with a mean error under 1e-4 (tests/test_torch_deform.py);
- gradients: rtol 1e-3 / atol 5e-5 x the leaf's max |g| in fp32; in the
  bf16 tier rtol 8e-3 (two bf16 ulps), of which at most 1% of elements
  (one in a leaf of under 100) may leave the bar, each within one bf16 ulp
  of the leaf's max |g|, the bar of the train-step file's bf16-cotangent
  test;
- one ``make_train_step`` step in se3 mode with the gate: loss rtol 1e-5;
  the gradients (read from Adam's moments after one step, as the
  train-step file does) at the fp32 bars; updated parameters rtol 1e-6 /
  atol 1e-5 x lr where the gradient is firm, else within 2 lr; ``denom``
  and ``max_radii2d`` exact.

The gate runs in fp32 whatever the config's tier (JAX calls it without a
compute dtype).  The latent heads take no gradient and no Adam step.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import render_cli as jrender_cli
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu import train as jtrain
from gs_deformable_tpu.io import checkpoint as jckpt
from gs_deformable_tpu.io import model_ply as jmodel_ply
from gs_deformable_tpu.models import deform as jdeform
from gs_deformable_tpu.models import gaussians as jgaussians
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu_torch import config, convert, training
from gs_deformable_tpu_torch.io import checkpoint, model_ply
from gs_deformable_tpu_torch.models import deform as tdeform
from gs_deformable_tpu_torch.models.gaussians import tree_leaves, tree_map
from gs_deformable_tpu_torch.renderer import CameraArrays

from test_torch_train_step import GROUPS, STEP_KW, assert_grad_close, leaves, scene

SMALL = dict(depth=3, width=64, skips=(1,), warmup_iters=100)
ITER, WARMUP_ITER = 7, 1  # the step's config has warmup 5


def se3_nets(seed, **over):
    jcfg = jconfig.DeformConfig(**{**SMALL, **over})
    params = jdeform.init_se3_net(jax.random.PRNGKey(seed), jcfg)
    cfg = config.DeformConfig(**{**SMALL, **over})
    net = tdeform.SE3Net(jax.tree_util.tree_map(np.asarray, params), cfg, device="cpu")
    return params, jcfg, net, cfg


def latent_heads(seed, **over):
    jcfg = jconfig.DeformConfig(**{**SMALL, **over})
    params = jdeform.make_latent_heads(jax.random.PRNGKey(seed), jcfg)
    cfg = config.DeformConfig(**{**SMALL, **over})
    heads = tdeform.make_latent_heads(jax.tree_util.tree_map(np.asarray, params), cfg,
                                      device="cpu")
    return params, jcfg, heads, cfg


def points(seed, n=257):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_se3_net_matches_jax(tier):
    params, jcfg, net, cfg = se3_nets(0, compute_dtype=tier)
    xyz, wts = points(1)
    jdtype = jnp.bfloat16 if tier == "bfloat16" else None

    def jloss(p, x):
        moved = jdeform.deform_se3(p, x, 0.375, jnp.asarray(500), jcfg, compute_dtype=jdtype)
        return jnp.sum(moved * wts), moved

    (jl, jmoved), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(xyz))
    x = torch.from_numpy(xyz).requires_grad_(True)
    moved = tdeform.deform_se3(net, x, 0.375, 500, cfg)
    loss = (moved * torch.from_numpy(wts)).sum()
    gs = torch.autograd.grad(loss, [x, *tree_leaves(net.param_tree())])
    got, ref = moved.detach().numpy(), np.asarray(jmoved)
    rtol = 1e-3 if tier == "float32" else 8e-3
    if tier == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
        assert np.abs(got - ref).mean() < 1e-4
    assert np.abs(got - xyz).max() > 0.05  # the net moves the points
    it = iter(gs[1:])
    mine = tree_map(lambda _: next(it).numpy(), net.param_tree())
    pairs = [("xyz", gs[0].numpy(), np.asarray(jgx))] + [
        (name, g, r) for (name, r), (_, g) in zip(
            leaves(jax.tree_util.tree_map(np.asarray, jgp)), leaves(mine), strict=True)]
    for name, g, r in pairs:
        if tier == "float32":
            assert_grad_close(g, r, name, rtol)
            continue
        # A cotangent one fp32 ulp apart can round to the neighbouring bf16
        # value: as test_torch_train_step.py's bf16-cotangent bar, at most 1%
        # of elements may leave the bar, each within one bf16 ulp of the
        # leaf's max |g|.
        scale = np.abs(r).max()
        off = np.abs(g - r) > rtol * np.abs(r) + 5e-5 * scale
        assert off.sum() <= max(1, 0.01 * off.size), f"{name}: {off.sum()} of {off.size} off"
        assert np.abs(g - r).max() <= 2.0 ** -8 * scale, name


@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_gate_matches_jax_in_fp32(tier):
    """The gate and its gradient to xyz match JAX's; under a bf16 config the
    port's gate is bitwise its fp32 one (JAX passes no compute dtype)."""
    params, jcfg, heads, cfg = latent_heads(2, compute_dtype=tier)
    xyz, _ = points(3)
    wts = np.random.default_rng(4).normal(size=(len(xyz), 1)).astype(np.float32)

    def jloss(x):
        g = jdeform.opacity_mask_gate(params, x, 0.6, jnp.asarray(500), jcfg)
        return jnp.sum(g * wts), g

    (jl, jg), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(xyz))
    x = torch.from_numpy(xyz).requires_grad_(True)
    gate = tdeform.opacity_mask_gate(heads, x, 0.6, 500, cfg)
    loss = (gate * torch.from_numpy(wts)).sum()
    (gx,) = torch.autograd.grad(loss, [x])
    np.testing.assert_allclose(gate.detach().numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    assert_grad_close(gx.numpy(), np.asarray(jgx), "gate xyz", rtol=1e-3)
    fp32 = tdeform.opacity_mask_gate(heads, x, 0.6, 500,
                                     dataclasses.replace(cfg, compute_dtype="float32"))
    assert torch.equal(gate, fp32)
    assert 0.0 < float(gate.detach().min()) and float(gate.detach().max()) < 1.0
    # No gradient reaches the heads' own weights.
    assert not any(p.requires_grad for m in heads.values() for p in m.parameters())


@pytest.mark.parametrize("iteration", [0, 99])
def test_warmup_leaves_means_and_opacity(iteration):
    params, jcfg, net, cfg = se3_nets(5, compute_dtype="float32")
    lparams, _, heads, _ = latent_heads(6, compute_dtype="float32")
    xyz, _ = points(7, n=9)
    x = torch.from_numpy(xyz)
    assert tdeform.deform_se3(net, x, 0.5, iteration, cfg) is x
    np.testing.assert_array_equal(
        np.asarray(jdeform.deform_se3(params, jnp.asarray(xyz), 0.5, jnp.asarray(iteration),
                                      jcfg)), xyz)
    gate = tdeform.opacity_mask_gate(heads, x, 0.5, iteration, cfg)
    jgate = jdeform.opacity_mask_gate(lparams, jnp.asarray(xyz), 0.5, jnp.asarray(iteration),
                                      jcfg)
    assert gate.shape == (9, 1) and bool((gate == 1).all())
    assert (np.asarray(jgate) == 1).all()


def test_norm_gradient_at_zero_rotation():
    """w = 0 exactly (zero w head): the port's gradient is finite; JAX's
    gradient of ``jnp.linalg.norm`` at 0 is not (ROADMAP section C)."""
    params, jcfg, net, cfg = se3_nets(8, compute_dtype="float32")
    np_params = jax.tree_util.tree_map(np.array, params)
    np_params["heads"][0]["w"][:] = 0.0
    np_params["heads"][0]["b"][:] = 0.0
    net = tdeform.SE3Net(np_params, cfg, device="cpu")
    xyz, wts = points(9, n=16)
    x = torch.from_numpy(xyz).requires_grad_(True)
    moved = tdeform.deform_se3(net, x, 0.5, 500, cfg)
    gs = torch.autograd.grad((moved * torch.from_numpy(wts)).sum(),
                             [x, *tree_leaves(net.param_tree())])
    assert all(bool(torch.isfinite(g).all()) for g in gs)
    jg = jax.grad(lambda p: jnp.sum(jdeform.deform_se3(
        p, jnp.asarray(xyz), 0.5, jnp.asarray(500), jcfg) * wts))(
        jax.tree_util.tree_map(jnp.asarray, np_params))
    assert not np.isfinite(np.asarray(jg["heads"][0]["w"])).all()
    # The moved means themselves agree: v / 1e-12 times theta = 0.
    ref = jdeform.deform_se3(jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(xyz),
                             0.5, jnp.asarray(500), jcfg)
    np.testing.assert_array_equal(moved.detach().numpy(), np.asarray(ref))


def step_configs(mod):
    return mod.Config(
        model=mod.ModelConfig(sh_degree=1, deform_mode="se3", use_opacity_mask=True),
        deform=mod.DeformConfig(depth=2, width=32, warmup_iters=5, sh_coeffs=4,
                                compute_dtype="float32"),
        raster=mod.RasterizeConfig(instance_capacity=2048, chunk=8))


def port_state(np_ts, cfg, seed=0):
    g = np_ts.gaussians
    arrays = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    adam = {"mu": np_ts.adam.mu, "nu": np_ts.adam.nu, "step": np_ts.adam.step}
    return convert.train_state_from_jax_numpy(arrays, np_ts.deform, adam, cfg, device="cpu",
                                              seed=seed, latent_params=np_ts.latent)


@pytest.fixture(scope="module")
def se3_run():
    """One JAX compile; the JAX and port steps at ITER and at WARMUP_ITER."""
    jcfg, cfg = step_configs(jconfig), step_configs(config)
    state, view, full, gt = scene()
    jstep = jtraining.make_train_step(jcfg, **STEP_KW)
    tstep = training.make_train_step(cfg, **STEP_KW, device="cpu")
    jcam = JCameraArrays(jnp.asarray(view), jnp.asarray(full), jnp.zeros(3), jnp.float32(0.4))
    cam = CameraArrays.from_numpy(view, full, np.zeros(3), 0.4, device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(state, seed=0,
                                                                         cfg=jcfg))
    # The drawn net turns the cloud ~90 degrees, out of view; heads scaled
    # by 0.05 move it a little, so the step renders what it trains.
    heads = [{k: 0.05 * v for k, v in h.items()} for h in init.deform["heads"]]
    init = init.replace(deform={**init.deform, "heads": heads})
    out = {"init": init}
    for it in (ITER, WARMUP_ITER):
        ts, jm = jstep(jax.tree_util.tree_map(jnp.array, init), jcam, jnp.asarray(gt),
                       jnp.zeros(3), jnp.asarray(it))
        start = port_state(init, cfg)
        port, tm = tstep(start, cam, torch.from_numpy(gt), torch.zeros(3), it)
        out[it] = dict(jax=jax.tree_util.tree_map(np.asarray, ts), port_ts=port,
                       port=convert.train_state_to_numpy(port),
                       jm={k: np.asarray(v) for k, v in jm.items()},
                       tm={k: v.numpy() for k, v in tm.items()},
                       lrs={k: float(v) for k, v in jtraining.learning_rates(it, jcfg,
                                                                             1.0).items()})
    return out


@pytest.mark.parametrize("it", [ITER, WARMUP_ITER])
def test_se3_step_matches_jax(se3_run, it):
    r = se3_run[it]
    for name in ("loss", "ll1", "ssim", "offset_norm", "psnr"):
        np.testing.assert_allclose(r["tm"][name], r["jm"][name], rtol=1e-5, err_msg=name)
    for key in ("required_instances", "required_aligned", "n_alive"):
        assert int(r["tm"][key]) == int(r["jm"][key]), key
    assert (float(r["tm"]["offset_norm"]) > 0) == (it == ITER)
    for moment in ("mu", "nu"):
        jl, tl = leaves(getattr(r["jax"].adam, moment)), leaves(r["port"]["adam"][moment])
        assert [n for n, _ in jl] == [n for n, _ in tl]
        for (name, ref), (_, got) in zip(jl, tl):
            if moment == "nu":
                ref, got = np.sqrt(ref / 0.001), np.sqrt(got / 0.001)
            assert_grad_close(got, ref, f"{moment} {name}", rtol=1e-3)
    jg, tg = r["jax"].gaussians, r["port"]["gaussians"]
    assert tg["denom"].sum() > 30  # most of the 40 gaussians are in view
    np.testing.assert_array_equal(tg["denom"], np.asarray(jg.denom))
    np.testing.assert_array_equal(tg["max_radii2d"], np.asarray(jg.max_radii2d))
    assert_grad_close(tg["xyz_gradient_accum"], np.asarray(jg.xyz_gradient_accum),
                      "xyz_gradient_accum", rtol=1e-3)
    np.testing.assert_allclose(tg["last_offset_norm"], np.asarray(jg.last_offset_norm),
                               rtol=1e-5, atol=1e-6)


def test_se3_step_updated_params_match_jax(se3_run):
    r, init = se3_run[ITER], se3_run["init"]

    def params(g, deform):
        p = {k: np.asarray(g[k] if isinstance(g, dict) else getattr(g, k)) for k in GROUPS}
        p["offset_model"] = deform
        return leaves(p)

    mus = dict(leaves(r["jax"].adam.mu))
    for (name, ref), (_, got), (_, start) in zip(
            params(r["jax"].gaussians, r["jax"].deform),
            params(r["port"]["gaussians"], r["port"]["deform"]),
            params(init.gaussians, init.deform), strict=True):
        lr = r["lrs"][name.split("/")[1].split("[")[0]]
        g = mus[name] / 0.1
        firm = np.abs(g) > 5e-5 * (np.abs(g).max() + 1e-30)
        # se3 leaves rotations as they are: the isotropic initial splats give
        # them no gradient.
        assert firm.any() or name == "/rotation", name
        assert np.all(got[firm] != start[firm]), name
        np.testing.assert_allclose(got[firm], ref[firm], rtol=1e-6, atol=1e-5 * lr, err_msg=name)
        assert np.all(np.abs(got - ref) <= 2 * lr * (1 + 1e-5) + 1e-7), name


def test_latent_heads_take_no_step(se3_run):
    r, init = se3_run[ITER], se3_run["init"]
    assert set(r["port"]["adam"]["mu"]) == set(GROUPS) | {"offset_model"}
    assert isinstance(r["port_ts"].net, tdeform.SE3Net)
    for (name, a), (_, b), (_, c) in zip(leaves(r["port"]["latent"]), leaves(init.latent),
                                         leaves(r["jax"].latent), strict=True):
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, c, err_msg=name)
    for m in r["port_ts"].latent.values():
        assert all(p.grad is None and not p.requires_grad for p in m.parameters())


def random_jax_state(seed):
    """A se3 + gate JAX TrainState with every field, net and moment seeded."""
    rng = np.random.default_rng(seed)
    jcfg = step_configs(jconfig)
    st = jgaussians.init_from_points(rng.normal(size=(30, 3)).astype(np.float32),
                                     rng.uniform(size=(30, 3)).astype(np.float32),
                                     capacity=48, sh_degree=1)
    ts = jtraining.init_train_state(st, seed, jcfg)

    def rand(x):
        if x.dtype == jnp.bool_:
            return jnp.asarray(rng.uniform(size=x.shape) < 0.7)
        if jnp.issubdtype(x.dtype, jnp.integer):
            return x
        return jnp.asarray(rng.normal(size=x.shape).astype(np.float32))

    ts = ts.replace(gaussians=jax.tree_util.tree_map(rand, ts.gaussians),
                    deform=jax.tree_util.tree_map(rand, ts.deform),
                    latent=jax.tree_util.tree_map(rand, ts.latent),
                    adam=ts.adam.replace(mu=jax.tree_util.tree_map(rand, ts.adam.mu),
                                         nu=jax.tree_util.tree_map(rand, ts.adam.nu),
                                         step=jnp.asarray(9, jnp.int32)))
    return jax.tree_util.tree_map(np.asarray, ts)


def assert_same_state(np_ts, ts):
    out = convert.train_state_to_numpy(ts)
    for name, a in out["gaussians"].items():
        np.testing.assert_array_equal(a, getattr(np_ts.gaussians, name), err_msg=name)
    for ours, theirs in ((out["deform"], np_ts.deform), (out["latent"], np_ts.latent),
                         (out["adam"]["mu"], np_ts.adam.mu), (out["adam"]["nu"], np_ts.adam.nu)):
        lo, lt = leaves(ours), leaves(theirs)
        assert [n for n, _ in lo] == [n for n, _ in lt]
        for (name, a), (_, b) in zip(lo, lt):
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert out["adam"]["step"] == int(np_ts.adam.step)
    assert isinstance(ts.net, tdeform.SE3Net)


def test_checkpoint_latent_both_ways(tmp_path):
    cfg = step_configs(config)
    np_ts = random_jax_state(1)
    p = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(p, jax.tree_util.tree_map(jnp.asarray, np_ts), 21)
    ts, it = checkpoint.load_checkpoint(p, port_state(random_jax_state(2), cfg))
    assert it == 21
    assert_same_state(np_ts, ts)

    mine = port_state(random_jax_state(3), cfg)
    q = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(q, mine, 22)
    assert any(k.startswith(".latent/['opacity_mask']") for k in np.load(q).files)
    back, it = jckpt.load_checkpoint(q, jax.tree_util.tree_map(jnp.asarray, random_jax_state(4)))
    assert it == 22
    assert_same_state(jax.tree_util.tree_map(np.asarray, back), mine)


def test_five_net_files_both_ways(tmp_path):
    cfg = step_configs(config)
    np_ts = random_jax_state(5)
    jts = jax.tree_util.tree_map(jnp.asarray, np_ts)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmodel_ply.save_ply(jdir, jts.gaussians, nets=jtrain.nets_dict(jts))
    mine = port_state(np_ts, cfg)
    model_ply.save_ply(tdir, mine.gaussians, nets=model_ply.nets_dict(mine.net, mine.latent))
    for name in model_ply.NET_FILES:
        with np.load(os.path.join(jdir, f"{name}.npz")) as a, \
                np.load(os.path.join(tdir, f"{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
    # JAX files into the port: an SE3Net and four heads.
    net = model_ply.load_net(os.path.join(jdir, "offset_model.npz"), cfg.deform, "cpu",
                             kind=tdeform.SE3Net)
    for (name, a), (_, b) in zip(leaves(net.numpy_params()), leaves(np_ts.deform)):
        np.testing.assert_array_equal(a, b, err_msg=f"se3 net {name}")
    fresh = port_state(random_jax_state(6), cfg)
    latent, n = model_ply.load_latent(jdir, fresh.latent, "cpu")
    assert n == 4
    for key, m in latent.items():
        for (name, a), (_, b) in zip(leaves(m.numpy_params()), leaves(np_ts.latent[key])):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {name}")
    # The port's files into JAX's render-CLI loader.
    target = jax.tree_util.tree_map(jnp.asarray, random_jax_state(7))
    loaded, n = jrender_cli.restore_nets(target, tdir)
    assert n == 5
    for (name, a), (_, b) in zip(leaves(jax.tree_util.tree_map(np.asarray, loaded.latent)),
                                 leaves(np_ts.latent)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for (name, a), (_, b) in zip(leaves(jax.tree_util.tree_map(np.asarray, loaded.deform)),
                                 leaves(np_ts.deform)):
        np.testing.assert_array_equal(a, b, err_msg=name)
