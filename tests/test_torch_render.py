"""Port parity for the whole render slice, model loading and the port's rules.

- renderer.render and training.make_eval_render vs the JAX render (the
  Pallas composite in interpret mode): image rtol 1e-4 / atol 2e-5 and
  final_T rtol 1e-4 / atol 2e-6, the reference's own bars
  (tests/test_rasterize.py:64-65).  The two preprocess passes round a few
  floats apart, which moves T by ~1e-5 relative after a few dozen blends;
  for the same reason instance counts are not compared.
- A PLY and offset net saved by the JAX package load into the port.
- The port imports neither jax nor the JAX package; it never falls back
  to the CPU quietly; CPU tensors never launch a kernel.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import renderer as jrenderer
from gs_deformable_tpu.io import model_ply as jmodel_ply
from gs_deformable_tpu.models import deform as jdeform
from gs_deformable_tpu.models.gaussians import GaussianState as JGaussianState
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu_torch import config, convert, renderer, training
from gs_deformable_tpu_torch.io import model_ply
from gs_deformable_tpu_torch.models.deform import OffsetNet, init_offset_params
from gs_deformable_tpu_torch.models.gaussians import GaussianState
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.parallel import multihost, sharding

W, H = 80, 48
FOVX = 0.9
FOVY = 2 * np.arctan(np.tan(FOVX / 2) * H / W)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scene_arrays(seed, n=160, cap=192):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(3.0, 8.0, n)], -1).astype(np.float32)

    def pad(a, fill=0.0):
        return np.pad(a, [(0, cap - n)] + [(0, 0)] * (a.ndim - 1), constant_values=fill)

    rot = pad(rng.normal(size=(n, 4)).astype(np.float32))
    rot[n:, 0] = 1.0
    return {
        "xyz": pad(xyz),
        "f_dc": pad(rng.normal(size=(n, 1, 3)).astype(np.float32) * 0.8),
        "f_rest": pad(rng.normal(size=(n, 15, 3)).astype(np.float32) * 0.1),
        "opacity": pad(rng.normal(size=(n, 1)).astype(np.float32)),
        "scaling": pad(np.log(0.06 * rng.uniform(0.5, 2.0, (n, 3))).astype(np.float32)),
        "rotation": rot,
        "alive": pad(np.ones(n, bool)),
    }


def jax_state(a):
    cap = a["xyz"].shape[0]
    z = np.zeros
    return JGaussianState(
        **{k: jnp.asarray(v) for k, v in a.items()},
        max_radii2d=jnp.asarray(z(cap, np.float32)),
        xyz_gradient_accum=jnp.asarray(z((cap, 1), np.float32)),
        denom=jnp.asarray(z((cap, 1), np.float32)),
        last_offset_norm=jnp.asarray(z(cap, np.float32)))


def camera_np(time):
    ang = 0.15
    view = np.eye(4, dtype=np.float32)
    view[0, 0] = view[2, 2] = np.cos(ang)
    view[0, 2], view[2, 0] = -np.sin(ang), np.sin(ang)
    view[3, :3] = [0.1, 0.05, 0.3]
    full = view @ jtf.projection_matrix(0.01, 100.0, FOVX, FOVY)
    center = np.linalg.inv(view)[3, :3].astype(np.float32)
    return view, full, center, np.float32(time)


DEFORM = dict(depth=3, width=48, skips=(1,), warmup_iters=100, compute_dtype="float32")
RASTER = dict(instance_capacity=4096, chunk=8)


def configs(**raster):
    jcfg = jconfig.Config(deform=jconfig.DeformConfig(**DEFORM),
                          raster=jconfig.RasterizeConfig(**{**RASTER, **raster}))
    cfg = config.Config(deform=config.DeformConfig(**DEFORM),
                        raster=config.RasterizeConfig(**{**RASTER, **raster}))
    return jcfg, cfg


def assert_image_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("time,iteration,cull", [(0.3, 5000, True), (0.8, 50, False)])
def test_render_matches_jax(time, iteration, cull):
    jcfg, cfg = configs(tile_cull=cull)
    arrays = scene_arrays(0)
    params = jdeform.init_offset_net(jax.random.PRNGKey(1), jcfg.deform)
    view, full, center, t = camera_np(time)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(iteration=iteration, width=W, height=H, tan_fovx=float(np.tan(FOVX / 2)),
              tan_fovy=float(np.tan(FOVY / 2)), active_sh_degree=3)
    jcam = jrenderer.CameraArrays(*(jnp.asarray(a) for a in (view, full, center, t)))
    ref, rdx = jrenderer.render(jax_state(arrays), params, jcam, bg=jnp.asarray(bg),
                                cfg=jcfg, interpret=True, **kw)
    state, net = convert.from_jax_numpy(arrays, jax.tree_util.tree_map(np.asarray, params),
                                        cfg, device="cpu")
    cam = renderer.CameraArrays.from_numpy(view, full, center, t, device="cpu")
    before = launch_counts()
    with torch.no_grad():  # render is differentiable; this compares values only
        out, dx = renderer.render(state, net, cam, bg=torch.from_numpy(bg), cfg=cfg,
                                  device="cpu", **kw)
    assert launch_counts() == before  # CPU tensors never launch a kernel
    assert out.image.shape == (3, H, W) and out.n_contrib.dtype == torch.int32
    assert int(out.required_instances) <= cfg.raster.instance_capacity
    assert_image_close(out.image.numpy(), np.asarray(ref.image))
    np.testing.assert_allclose(out.final_t.numpy(), np.asarray(ref.final_t), rtol=1e-4,
                               atol=2e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.means2d_ndc.numpy(), np.asarray(ref.means2d_ndc),
                               rtol=1e-5, atol=1e-5)

    run = training.make_eval_render(cfg, width=W, height=H, tan_fovx=kw["tan_fovx"],
                                    tan_fovy=kw["tan_fovy"], active_sh_degree=3,
                                    device="cpu")
    image = run(state, net, cam, torch.from_numpy(bg), iteration)
    assert torch.equal(image, out.image)


def test_jax_saved_model_loads_in_port(tmp_path):
    jcfg, cfg = configs()
    arrays = scene_arrays(2, n=40, cap=40)
    params = jdeform.init_offset_net(jax.random.PRNGKey(3), jcfg.deform)
    jmodel_ply.save_ply(str(tmp_path), jax_state(arrays), {"offset_model": params})
    ply = os.path.join(str(tmp_path), "point_cloud.ply")
    ref, _ = jmodel_ply.load_ply(ply, capacity=64, sh_degree=3)
    got, deg = model_ply.load_ply(ply, capacity=64, sh_degree=3, device="cpu")
    assert deg == 3
    for name in ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation", "alive"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    net = model_ply.load_net(os.path.join(str(tmp_path), "offset_model.npz"), cfg.deform,
                             device="cpu", kind=OffsetNet)
    back = net.numpy_params()
    for group in ("layers", "heads"):
        for a, b in zip(back[group], params[group], strict=True):
            np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))
            np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, gs_deformable_tpu_torch as p\n"
        "import chip_smoke\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gs_deformable_tpu' or m.startswith('gs_deformable_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    # chip_smoke.py imports the port inside its functions: none of its
    # imports, at any depth, may name jax or the JAX package.
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "gs_deformable_tpu_torch" in {n.split(".")[0] for n in names}
    assert not [n for n in names if n.split(".")[0] in ("jax", "gs_deformable_tpu")], names


def test_no_quiet_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs()
    kw = dict(width=W, height=H, tan_fovx=0.4, tan_fovy=0.3, active_sh_degree=3)
    with pytest.raises(RuntimeError, match="cuda"):
        training.make_eval_render(cfg, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        training.make_train_step(cfg, spatial_lr_scale=1.0, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        renderer.CameraArrays.from_numpy(*camera_np(0.5))
    arrays = scene_arrays(4, n=8, cap=8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_jax_numpy(arrays, None, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        GaussianState.from_numpy(arrays)
    with pytest.raises(RuntimeError, match="cuda"):
        OffsetNet(init_offset_params(0, cfg.deform), cfg.deform)
    state, _ = convert.from_jax_numpy(arrays, None, cfg, device="cpu")
    cam = renderer.CameraArrays.from_numpy(*camera_np(0.5), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        renderer.render(state, None, cam, iteration=0, bg=torch.zeros(3),
                        cfg=cfg.replace(model=config.ModelConfig(deform_mode="none")), **kw)
    # The mesh: its constructors and makers take the card unless told otherwise.
    with pytest.raises(RuntimeError, match="cuda"):
        sharding.make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize_from_env()
    mesh = sharding.Mesh(1, 1, 0, 0, torch.device("cuda"))
    for make in (lambda: sharding.make_sharded_train_step(cfg, mesh, spatial_lr_scale=1.0, **kw),
                 lambda: sharding.make_sharded_chunk_step(cfg, mesh, spatial_lr_scale=1.0, **kw),
                 lambda: sharding.make_sharded_densify_step(cfg, mesh, 1.0, False),
                 lambda: sharding.make_sharded_opacity_reset(cfg, mesh),
                 lambda: sharding.batch_cameras([cam])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_unported_knobs_raise():
    # The mesh is ported: data and model axes above 1 pass, below 1 raise.
    for axes in (dict(data_axis=2), dict(model_axis=2), dict(data_axis=2, model_axis=4)):
        config.check_supported(config.Config(parallel=config.ParallelConfig(**axes)))
    for axes in (dict(data_axis=0), dict(model_axis=0)):
        with pytest.raises(ValueError, match="at least 1"):
            config.check_supported(config.Config(parallel=config.ParallelConfig(**axes)))
    config.check_supported(config.Config())
    # The deformation variants are ported.
    for model in (config.ModelConfig(deform_mode="se3"),
                  config.ModelConfig(use_opacity_mask=True),
                  config.ModelConfig(deform_mode="se3", use_opacity_mask=True)):
        config.check_supported(config.Config(model=model))
    with pytest.raises(ValueError):
        config.check_supported(config.Config(model=config.ModelConfig(deform_mode="x")))
    # The packed knobs are ported: the same two kernels, a sub_chunk-aligned
    # layout and the truncated-depth sort.
    for raster in (config.RasterizeConfig(composite_mode="packed"),
                   config.RasterizeConfig(sort_mode="packed"),
                   config.RasterizeConfig(composite_mode="packed", sort_mode="packed",
                                          chunk=8, sub_chunk=2)):
        config.check_supported(config.Config(raster=raster))
    for mode in ("mixed", "batch", "stream"):  # one function, the same two kernels
        config.check_supported(config.Config(raster=config.RasterizeConfig(composite_mode=mode)))
    for raster in (config.RasterizeConfig(grad_reduce="x"),
                   config.RasterizeConfig(composite_mode="packed", sub_chunk=48),
                   config.RasterizeConfig(composite_mode="packed", sub_chunk=0),
                   config.RasterizeConfig(composite_mode="x"),
                   config.RasterizeConfig(sort_mode="x")):
        with pytest.raises(ValueError):
            config.check_supported(config.Config(raster=raster))


def test_config_defaults_match_jax():
    import dataclasses

    for jc, tc in ((jconfig.ModelConfig, config.ModelConfig),
                   (jconfig.DeformConfig, config.DeformConfig),
                   (jconfig.RasterizeConfig, config.RasterizeConfig),
                   (jconfig.OptimizationConfig, config.OptimizationConfig)):
        assert dataclasses.asdict(jc()) == dataclasses.asdict(tc()), tc.__name__
