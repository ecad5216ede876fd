"""Port parity end to end: a scene on disk to a saved model and back.

A D-NeRF scene written by tests/synthetic_scene.py goes through each
package's ``Scene`` (seeded alike, one copy of the scene each),
``init_from_points`` at the trainer's capacity rule, one train step,
``make_densify_step`` with JAX's draw, and a checkpoint that each package
writes and the other loads.  Bars: the scenes and clouds equal; the
initial states at tests/test_torch_densify.py's init bars; the step's loss
at rtol 1e-5 (tests/test_torch_train_step.py); densify on the JAX step's
state at tests/test_torch_densify.py's bars; the checkpoints bitwise on
every shared field, and the reloaded state renders bitwise the same image.
"""

import dataclasses
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.data.scene import Scene as JScene
from gs_deformable_tpu.io import checkpoint as jckpt
from gs_deformable_tpu.models import gaussians as jgaussians
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu.train import cfg_capacity
from gs_deformable_tpu_torch import config, convert, training
from gs_deformable_tpu_torch.data.cameras import camera_arrays
from gs_deformable_tpu_torch.data.scene import Scene
from gs_deformable_tpu_torch.io import checkpoint
from gs_deformable_tpu_torch.models import gaussians as tgaussians

from synthetic_scene import build_blender_scene
from test_torch_densify import assert_train_states, jax_draw
from test_torch_io import assert_shared_equal

SEED, POINTS, ITER = 11, 300, 7


def configs(mod):
    return mod.Config(
        model=mod.ModelConfig(sh_degree=1),
        deform=mod.DeformConfig(depth=2, width=32, warmup_iters=5, sh_coeffs=4,
                                compute_dtype="float32"),
        raster=mod.RasterizeConfig(instance_capacity=8192, chunk=8))


def to_port(np_ts, cfg):
    g = np_ts.gaussians
    arrays = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    adam = {"mu": np_ts.adam.mu, "nu": np_ts.adam.nu, "step": np_ts.adam.step}
    return convert.train_state_from_jax_numpy(arrays, np_ts.deform, adam, cfg, device="cpu")


def test_scene_to_saved_model(tmp_path):
    src = build_blender_scene(str(tmp_path / "src"), n_views=4, n_test=2, size=32)
    shutil.copytree(src, str(tmp_path / "jax_scene"))
    shutil.copytree(src, str(tmp_path / "port_scene"))
    np.random.seed(SEED)
    random.seed(SEED)
    js = JScene(str(tmp_path / "jax_scene"), str(tmp_path / "jax_model"), eval=True,
                random_init_points=POINTS)
    ts_scene = Scene(str(tmp_path / "port_scene"), str(tmp_path / "port_model"), eval=True,
                     random_init_points=POINTS, rng=np.random.RandomState(SEED),
                     shuffle_rng=random.Random(SEED))
    jpcd, pcd = js.scene_info.point_cloud, ts_scene.scene_info.point_cloud
    np.testing.assert_array_equal(pcd.points, jpcd.points)
    np.testing.assert_array_equal(pcd.colors, jpcd.colors)

    jcfg, cfg = configs(jconfig), configs(config)
    cap = cfg_capacity(jcfg, len(pcd.points))
    assert cap == 1024
    jst = jgaussians.init_from_points(jpcd.points, jpcd.colors, capacity=cap, sh_degree=1)
    st = tgaussians.init_from_points(pcd.points, pcd.colors, capacity=cap, sh_degree=1,
                                     device="cpu")
    np.testing.assert_allclose(np.exp(2.0 * st.scaling.numpy()),
                               np.exp(2.0 * np.asarray(jst.scaling)), rtol=1e-4,
                               atol=1e-6 * float(np.abs(pcd.points).max()) ** 2)
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(jst.xyz))
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(jst.alive))

    # One train step from the same state (the JAX init, whose net both use).
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(jst, seed=0, cfg=jcfg))
    jcam_info = js.get_train_cameras()[0]
    cam_info = ts_scene.get_train_cameras()[0]
    assert cam_info.image_name == jcam_info.image_name
    np.testing.assert_array_equal(cam_info.image, jcam_info.image)
    kw = dict(width=cam_info.width, height=cam_info.height, tan_fovx=cam_info.tan_fovx,
              tan_fovy=cam_info.tan_fovy, active_sh_degree=1,
              spatial_lr_scale=ts_scene.cameras_extent)
    jstep = jtraining.make_train_step(jcfg, **kw)
    jcam = JCameraArrays(jnp.asarray(jcam_info.world_view), jnp.asarray(jcam_info.full_proj),
                         jnp.asarray(jcam_info.camera_center), jnp.float32(jcam_info.time))
    jts, jm = jstep(jax.tree_util.tree_map(jnp.array, init), jcam,
                    jnp.asarray(jcam_info.image), jnp.zeros(3), jnp.asarray(ITER))
    step = training.make_train_step(cfg, **kw, device="cpu")
    cam = camera_arrays(cam_info, device="cpu")
    _, m = step(to_port(init, cfg), cam, torch.from_numpy(cam_info.image), torch.zeros(3), ITER)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    after = jax.tree_util.tree_map(np.asarray, jts)

    # Densify the JAX step's state in both packages with JAX's draw.
    accum = after.gaussians.xyz_gradient_accum / np.maximum(after.gaussians.denom, 1)
    threshold = float(np.median(accum[accum > 0]))
    jdens = jtraining.make_densify_step(jcfg, extent=js.cameras_extent, use_screen_prune=False)
    jref, jinfo = jdens(jax.tree_util.tree_map(jnp.array, after), jnp.float32(threshold),
                        jnp.float32(0.005))
    dens = training.make_densify_step(cfg, extent=ts_scene.cameras_extent,
                                      use_screen_prune=False, device="cpu")
    out, info = dens(to_port(after, cfg), threshold, 0.005, normals=jax_draw(after))
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in jinfo.items()}
    assert int(info["n_cloned"]) + int(info["n_split"]) > 0
    jref = jax.tree_util.tree_map(np.asarray, jref)
    assert_train_states(out, jref, after)

    # Checkpoints both ways.
    port_ck, jax_ck = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_checkpoint(port_ck, out, ITER)
    loaded, it = jckpt.load_checkpoint(port_ck, jax.tree_util.tree_map(jnp.asarray, jref))
    assert it == ITER
    assert_shared_equal(jax.tree_util.tree_map(np.asarray, loaded), out)
    jckpt.save_checkpoint(jax_ck, jax.tree_util.tree_map(jnp.asarray, jref), ITER)
    back, it = checkpoint.load_checkpoint(jax_ck, to_port(after, cfg))
    assert it == ITER
    assert_shared_equal(jref, back)

    run = training.make_eval_render(cfg, width=cam_info.width, height=cam_info.height,
                                    tan_fovx=cam_info.tan_fovx, tan_fovy=cam_info.tan_fovy,
                                    active_sh_degree=1, device="cpu")
    reloaded, _ = checkpoint.load_checkpoint(port_ck, to_port(after, cfg))
    assert torch.equal(run(reloaded.gaussians, reloaded.net, cam, torch.zeros(3), ITER),
                       run(out.gaussians, out.net, cam, torch.zeros(3), ITER))
