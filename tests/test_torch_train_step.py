"""Port parity: one training step of the port vs the JAX ``make_train_step``.

The tiny scene and config of tests/test_train_step.py (48x32, SH degree 1,
a 2x32 offset net, warmup 5, chunk 8) start from the same JAX
``TrainState``, carried into the port by ``convert.train_state_from_jax_numpy``;
the JAX Pallas composite runs in interpret mode.

Adam's first step from zero moments is a sign function (m/sqrt(v) = g/|g|,
eps 1e-15), so a parameter whose gradient is ~0 moves by +-lr whichever
way rounding tips it.  The tests therefore compare the gradients: after
one step ``adam.mu = 0.1 g`` and ``adam.nu = 0.001 g^2`` on both sides,
read through JAX's public step with no change to the JAX package.  Bars:

- loss, ll1, ssim, offset_norm, psnr: rtol 1e-5;
- gradients (``mu``, and ``|g| = sqrt(nu / 0.001)``), per group and per net
  leaf, fp32 MLP tier: rtol 1e-3 / atol 5e-5 x the leaf's max |g| (the
  reference's end-to-end render-gradient bar, tests/test_rasterize.py:142);
  ``xyz_gradient_accum`` (|dL/d ndc mean2D|) at the same bar;
- bf16 MLP tier: every MLP cotangent is rounded to bf16, and a value that
  lands one fp32 ulp apart on the two sides can round to neighbouring bf16
  values, one bf16 ulp (2^-8 = 3.9e-3 relative) apart.  Bar: rtol 8e-3
  (two bf16 ulps) / atol 5e-5 x scale;
- ``bf16_cotangents=True`` net gradients: the bf16-tier bar, except that
  at most 1% of elements may leave it, each within one bf16 ulp of the
  leaf's max |g| (see the test);
- updated parameters: rtol 1e-6 / atol 1e-5 x lr where |g_jax| exceeds
  the gradient atol, else within 2 lr (the sign may tip);
- ``denom``, ``max_radii2d``, the Adam step count and the overflow counters:
  exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.models import deform as jdeform
from gs_deformable_tpu.models import gaussians as jgaussians
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu.utils import general as jgeneral
from gs_deformable_tpu.utils import losses as jlosses
from gs_deformable_tpu_torch import config, convert, training
from gs_deformable_tpu_torch.models import deform as tdeform
from gs_deformable_tpu_torch.models import gaussians as tgaussians
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.renderer import CameraArrays
from gs_deformable_tpu_torch.utils import general, losses

W, H = 48, 32
FOV = 0.8
TAN = float(np.tan(FOV / 2))
N_ALIVE, CAP = 40, 64
ITER = 7  # past the warmup of 5
WARMUP_ITER = 1
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")
STEP_KW = dict(width=W, height=H, tan_fovx=TAN, tan_fovy=TAN, active_sh_degree=1,
               spatial_lr_scale=1.0)


def configs(mod, **deform):
    return mod.Config(
        model=mod.ModelConfig(sh_degree=1),
        deform=mod.DeformConfig(depth=2, width=32, warmup_iters=5, sh_coeffs=4, **deform),
        raster=mod.RasterizeConfig(instance_capacity=2048, chunk=8))


def scene():
    """tests/test_train_step.py:make_setup, plus a seeded ground truth."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-1, 1, N_ALIVE), rng.uniform(-0.7, 0.7, N_ALIVE),
                    rng.uniform(3, 6, N_ALIVE)], -1).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (N_ALIVE, 3)).astype(np.float32)
    state = jgaussians.init_from_points(pts, cols, capacity=CAP, sh_degree=1)
    view = np.eye(4, dtype=np.float32)
    full = view @ np.asarray(jtf.projection_matrix(0.01, 100.0, FOV, FOV))
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return state, view, full, gt


def run_both(deform_kw):
    """One JAX compile; the JAX and port steps at ITER and at WARMUP_ITER."""
    jcfg, cfg = configs(jconfig, **deform_kw), configs(config, **deform_kw)
    state, view, full, gt = scene()
    jstep = jtraining.make_train_step(jcfg, **STEP_KW)
    tstep = training.make_train_step(cfg, **STEP_KW, device="cpu")
    jcam = JCameraArrays(jnp.asarray(view), jnp.asarray(full), jnp.zeros(3), jnp.float32(0.4))
    cam = CameraArrays.from_numpy(view, full, np.zeros(3), 0.4, device="cpu")
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(state, seed=0, cfg=jcfg))
    out = {}
    for it in (ITER, WARMUP_ITER):
        ts = jax.tree_util.tree_map(jnp.array, init)  # the step donates its input
        ts, jm = jstep(ts, jcam, jnp.asarray(gt), jnp.zeros(3), jnp.asarray(it))
        before = launch_counts()
        port, tm = tstep(to_port(init, cfg), cam, torch.from_numpy(gt), torch.zeros(3), it)
        assert launch_counts() == before  # CPU tensors never launch a kernel
        out[it] = dict(
            jax=jax.tree_util.tree_map(np.asarray, ts), port=convert.train_state_to_numpy(port),
            jm={k: np.asarray(v) for k, v in jm.items()}, tm={k: v.numpy() for k, v in tm.items()},
            lrs={k: float(v) for k, v in jtraining.learning_rates(it, jcfg, 1.0).items()})
    out["init"] = init
    return out


def to_port(np_ts, cfg):
    g = np_ts.gaussians
    arrays = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    adam = {"mu": np_ts.adam.mu, "nu": np_ts.adam.nu, "step": np_ts.adam.step}
    return convert.train_state_from_jax_numpy(arrays, np_ts.deform, adam, cfg, device="cpu")


@pytest.fixture(scope="module")
def fp32_run():
    return run_both(dict(compute_dtype="float32"))


@pytest.fixture(scope="module")
def bf16_run():
    return run_both(dict(compute_dtype="bfloat16"))


def leaves(tree, prefix=""):
    """(name, array) pairs of a {group: array or {"layers", "heads"} subtree}
    dict, keys sorted (jax.tree_util sorts them; the port keeps its own order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}[{i}]")]
    return [(prefix, np.asarray(tree))]


def assert_grad_close(got, ref, what, rtol):
    scale = np.abs(ref).max() + 1e-30
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=5e-5 * scale, err_msg=what)


def check_gradients(run, it, rtol):
    r = run[it]
    for moment in ("mu", "nu"):
        jl, tl = leaves(getattr(r["jax"].adam, moment)), leaves(r["port"]["adam"][moment])
        assert [n for n, _ in jl] == [n for n, _ in tl]
        for (name, ref), (_, got) in zip(jl, tl):
            if moment == "nu":  # |g| from nu = 0.001 g^2
                ref, got = np.sqrt(ref / 0.001), np.sqrt(got / 0.001)
            assert_grad_close(got, ref, f"{moment} {name}", rtol)
    assert r["port"]["adam"]["step"] == int(r["jax"].adam.step) == 1


@pytest.mark.parametrize("name", ["loss", "ll1", "ssim", "offset_norm", "psnr"])
def test_step_metrics_match_jax(fp32_run, name):
    r = fp32_run[ITER]
    np.testing.assert_allclose(r["tm"][name], r["jm"][name], rtol=1e-5, err_msg=name)
    for key in ("required_instances", "required_aligned", "n_alive"):
        assert int(r["tm"][key]) == int(r["jm"][key]), key
    assert set(r["tm"]) == set(r["jm"])


def test_step_gradients_match_jax(fp32_run):
    check_gradients(fp32_run, ITER, rtol=1e-3)


def test_dead_slots_get_zero_gradient(fp32_run):
    for it in (ITER, WARMUP_ITER):
        mu = fp32_run[it]["port"]["adam"]["mu"]
        for k in GROUPS:
            assert not mu[k][N_ALIVE:].any(), k
            # (In warmup the isotropic initial splats give rotation no gradient.)
            assert mu[k][:N_ALIVE].any() or (it, k) == (WARMUP_ITER, "rotation"), k


def test_step_densification_stats_match_jax(fp32_run):
    r = fp32_run[ITER]
    jg, tg = r["jax"].gaussians, r["port"]["gaussians"]
    np.testing.assert_array_equal(tg["denom"], np.asarray(jg.denom))
    np.testing.assert_array_equal(tg["max_radii2d"], np.asarray(jg.max_radii2d))
    assert tg["denom"].sum() > 0
    assert_grad_close(tg["xyz_gradient_accum"], np.asarray(jg.xyz_gradient_accum),
                      "xyz_gradient_accum", rtol=1e-3)
    np.testing.assert_allclose(tg["last_offset_norm"], np.asarray(jg.last_offset_norm),
                               rtol=1e-5, atol=1e-6)


def all_params(gaussians, deform):
    params = {k: np.asarray(gaussians[k] if isinstance(gaussians, dict)
                            else getattr(gaussians, k)) for k in GROUPS}
    params["offset_model"] = deform
    return leaves(params)


def test_step_updated_params_match_jax(fp32_run):
    r = fp32_run[ITER]
    ref_l = all_params(r["jax"].gaussians, r["jax"].deform)
    got_l = all_params(r["port"]["gaussians"], r["port"]["deform"])
    init_l = all_params(fp32_run["init"].gaussians, fp32_run["init"].deform)
    mus = dict(leaves(r["jax"].adam.mu))
    for (name, ref), (_, got), (_, init) in zip(ref_l, got_l, init_l, strict=True):
        lr = r["lrs"][name.split("/")[1].split("[")[0]]
        g = mus[name] / 0.1
        firm = np.abs(g) > 5e-5 * (np.abs(g).max() + 1e-30)
        assert firm.any() and np.all(got[firm] != init[firm]), name
        np.testing.assert_allclose(got[firm], ref[firm], rtol=1e-6, atol=1e-5 * lr, err_msg=name)
        assert np.all(np.abs(got - ref) <= 2 * lr * (1 + 1e-5) + 1e-7), name


def test_warmup_step(fp32_run):
    """Iteration 1 < warmup: offset_norm is exactly 0, the MLP gets finite
    zero gradients (and is left as it was), and the rest matches JAX."""
    r = fp32_run[WARMUP_ITER]
    assert float(r["tm"]["offset_norm"]) == 0.0 == float(r["jm"]["offset_norm"])
    for name, m in leaves(r["port"]["adam"]["mu"]["offset_model"]):
        assert np.isfinite(m).all() and not m.any(), name
    for (name, a), (_, b) in zip(leaves(r["port"]["deform"]), leaves(fp32_run["init"].deform)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(r["tm"]["loss"], r["jm"]["loss"], rtol=1e-5)
    check_gradients(fp32_run, WARMUP_ITER, rtol=1e-3)


def test_step_bf16_tier_matches_jax(bf16_run):
    r = bf16_run[ITER]
    for name in ("loss", "ll1", "ssim", "offset_norm"):
        np.testing.assert_allclose(r["tm"][name], r["jm"][name], rtol=1e-4, err_msg=name)
    check_gradients(bf16_run, ITER, rtol=8e-3)


def test_adam_step_matches_jax():
    rng = np.random.default_rng(3)

    def tree(scale=1.0):
        def a(*shape):
            return (rng.normal(size=shape) * scale).astype(np.float32)
        return {"xyz": a(7, 3), "opacity": a(7, 1),
                "offset_model": {"layers": [{"w": a(5, 4), "b": a(4)}],
                                 "heads": [{"w": a(4, 3), "b": a(3)}]}}

    params = tree()
    grads = [tree(1e-3), tree(1e-2)]
    grads[0]["xyz"][0] = 0.0  # a zero gradient: m / (sqrt(v) + eps) = 0
    lrs = {"xyz": 1.6e-4, "opacity": 0.05, "offset_model": 8e-4}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jgaussians.adam_init(jp)
    tp = tgaussians.tree_map(torch.from_numpy, params)
    topt = tgaussians.adam_init(tp)
    for g in grads:
        jp, jopt = jgaussians.adam_step(jp, jax.tree_util.tree_map(jnp.asarray, g), jopt,
                                        {k: jnp.float32(v) for k, v in lrs.items()})
        tp, topt = tgaussians.adam_step(tp, tgaussians.tree_map(torch.from_numpy, g), topt,
                                        {k: torch.tensor(v) for k, v in lrs.items()})
    assert int(topt.step) == int(jopt.step) == 2
    for jt, tt in ((jp, tp), (jopt.mu, topt.mu), (jopt.nu, topt.nu)):
        for (name, ref), (_, got) in zip(leaves(jt), leaves(tgaussians.tree_map(
                lambda t: t.numpy(), tt))):
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=name)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (3, 23, 37)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(losses.ssim_map(ta, tb).numpy(),
                               np.asarray(jlosses.ssim_map(ja, jb)), rtol=1e-5, atol=1e-6)
    for name in ("ssim", "l1_loss", "l2_loss"):
        np.testing.assert_allclose(getattr(losses, name)(ta, tb).numpy(),
                                   np.asarray(getattr(jlosses, name)(ja, jb)), rtol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(general.psnr(ta[None], tb[None]).numpy(),
                               np.asarray(jgeneral.psnr(ja[None], jb[None])), rtol=1e-6)
    x = torch.tensor([0.01, 0.1, 0.5, 0.9])
    np.testing.assert_allclose(general.inverse_sigmoid(x).numpy(),
                               np.asarray(jgeneral.inverse_sigmoid(jnp.asarray(x.numpy()))),
                               rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=40_000),
    dict(lr_init=8e-4, lr_final=1.6e-6, lr_delay_steps=500, lr_delay_mult=0.01,
         max_steps=40_000),
    dict(lr_init=0.0, lr_final=0.0, max_steps=40_000)])
def test_expon_lr_matches_jax(kw):
    for step in (-1, 0, 1000, kw["max_steps"]):
        got = general.expon_lr(step, **kw)
        ref = jgeneral.expon_lr(step, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, err_msg=str(step))
    assert float(general.expon_lr(-1, **kw)) == 0.0


def test_bf16_cotangents_match_jax():
    jcfg = jconfig.DeformConfig(depth=3, width=64, skips=(1,), warmup_iters=100)
    params = jdeform.init_offset_net(jax.random.PRNGKey(6), jcfg)
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-2, 2, (129, 3)).astype(np.float32)
    weights = [rng.normal(size=(129, d)).astype(np.float32) for d in (3, 3, 4, 48)]

    def jloss(p, x):
        outs = jdeform.deform_offsets(p, x, 0.3, jnp.asarray(500), jcfg,
                                      compute_dtype="bfloat16_bwd")
        return sum(jnp.sum(o * w) for o, w in zip(outs, weights))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(xyz))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    grads = {}
    for cot in (True, False):
        cfg = config.DeformConfig(depth=3, width=64, skips=(1,), warmup_iters=100,
                                  bf16_cotangents=cot)
        net = tdeform.OffsetNet(np_params, cfg, device="cpu")
        x = torch.from_numpy(xyz).requires_grad_(True)
        outs = tdeform.deform_offsets(net, x, 0.3, 500, cfg)
        loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights))
        tree = net.param_tree()
        gs = torch.autograd.grad(loss, [x, *tgaussians.tree_leaves(tree)])
        it = iter(gs[1:])
        grads[cot] = (gs[0].numpy(), tgaussians.tree_map(lambda _: next(it).numpy(), tree))
    gx, gp = grads[True]
    assert_grad_close(gx, np.asarray(jgx), "xyz", rtol=8e-3)
    for (name, ref), (_, got) in zip(leaves(jax.tree_util.tree_map(np.asarray, jgp)),
                                     leaves(gp)):
        # dw sums bf16-rounded operand products over rows: where one operand
        # rounded to the neighbouring bf16 value, a small sum moves by one
        # bf16 ulp of a term, so a few elements may leave the relative bar.
        scale = np.abs(ref).max()
        off = np.abs(got - ref) > 8e-3 * np.abs(ref) + 5e-5 * scale
        assert off.mean() <= 0.01, f"{name}: {off.sum()} of {off.size} off the bar"
        assert np.abs(got - ref).max() <= 2.0**-8 * scale, name
    # The option is live: the default bf16 tier rounds other cotangents.
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in
               zip(leaves(grads[True][1]), leaves(grads[False][1])))
