"""Port parity: capacity growth and the batched eval sweep.

``grow_capacity`` (tests/test_train_step.py:108) must pad the state and its
moments exactly as JAX does, and the grown state must render and train as
the original: equal images and loss.  ``make_eval_render_batch`` through
``eval_sweep`` (two frame sizes, so two groups, and a short last batch) is
held to JAX's: images at rtol 1e-4 / atol 2e-5 (the render bar), l1, PSNR
and SSIM at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu_torch import training
from gs_deformable_tpu_torch.renderer import CameraArrays

from test_torch_densify import assert_train_states, setup_scene, tiny_configs, train_states

W, H, FOV = 48, 32, 0.8
TAN = float(np.tan(FOV / 2))


def camera(time, shift=0.0):
    view = np.eye(4, dtype=np.float32)
    view[3, 0] = shift
    full = view @ np.asarray(jtf.projection_matrix(0.01, 100.0, FOV, FOV))
    center = np.linalg.inv(view)[3, :3].astype(np.float32)
    return view, full, center, np.float32(time)


def test_grow_capacity():
    """test_train_step.py:108: padded state and moments, the same render."""
    rng = np.random.default_rng(0)
    jcfg, cfg = tiny_configs()
    st = setup_scene(rng)
    init, ts = train_states(jcfg, cfg, st)
    ref = jax.tree_util.tree_map(np.asarray, jtraining.grow_capacity(
        jax.tree_util.tree_map(jnp.asarray, init), 128))
    grown = training.grow_capacity(train_states(jcfg, cfg, st)[1], 128)
    assert grown.gaussians.capacity == 128 and int(grown.gaussians.num_alive) == 40
    assert_train_states(grown, ref, ref)
    with pytest.raises(ValueError, match="exceed"):
        training.grow_capacity(ts, 64)

    cam = CameraArrays.from_numpy(*camera(0.4), device="cpu")
    bg = torch.zeros(3)
    kw = dict(width=W, height=H, tan_fovx=TAN, tan_fovy=TAN, active_sh_degree=1,
              device="cpu")
    before = training.make_eval_render(cfg, **kw)(ts.gaussians, ts.net, cam, bg, 7)
    after = training.make_eval_render(cfg, **kw)(grown.gaussians, grown.net, cam, bg, 7)
    assert torch.equal(before, after)
    step = training.make_train_step(cfg, spatial_lr_scale=1.0, **kw)
    gt = torch.from_numpy(rng.uniform(0, 1, (3, H, W)).astype(np.float32))
    _, m0 = step(ts, cam, gt, bg, 7)  # each state has its own net: the step writes it
    _, m1 = step(grown, cam, gt, bg, 7)
    assert float(m0["loss"]) == float(m1["loss"])
    grown2 = training.grow_capacity(ts, 256)
    assert grown2.net is ts.net and grown2.generator is ts.generator


def test_eval_sweep_matches_jax():
    """make_eval_render_batch through eval_sweep: two camera groups (two
    frame sizes), a short last batch, images and metrics against JAX."""
    rng = np.random.default_rng(5)
    jcfg, cfg = tiny_configs()
    init, ts = train_states(jcfg, cfg, setup_scene(rng))
    sizes = [(W, H)] * 3 + [(32, 32)] * 2
    cams = [dict(width=w, height=h, fovx=FOV, fovy=FOV, np=camera(0.1 + 0.2 * i, 0.05 * i))
            for i, (w, h) in enumerate(sizes)]
    cams = [type("Cam", (), c) for c in cams]
    gts = [rng.uniform(-0.1, 1.1, (3, c.height, c.width)).astype(np.float32) for c in cams]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    gt_of = {id(c): g for c, g in zip(cams, gts)}

    def jmake(c):
        return jtraining.make_eval_render_batch(jcfg, width=c.width, height=c.height,
                                                tan_fovx=TAN, tan_fovy=TAN, active_sh_degree=1)

    def tmake(c):
        return training.make_eval_render_batch(cfg, width=c.width, height=c.height,
                                               tan_fovx=TAN, tan_fovy=TAN, active_sh_degree=1,
                                               device="cpu")

    ref = jtraining.eval_sweep(jmake, jax.tree_util.tree_map(jnp.asarray, init), cams,
                               lambda c: JCameraArrays(*(jnp.asarray(a) for a in c.np)),
                               lambda c: gt_of[id(c)], jnp.asarray(bg), 7, batch=2)
    got = training.eval_sweep(tmake, ts, cams,
                              lambda c: CameraArrays.from_numpy(*c.np, device="cpu"),
                              lambda c: gt_of[id(c)], torch.from_numpy(bg), 7, batch=2)
    assert len(got) == len(cams)
    for (img, l1, ps, ss), (rimg, rl1, rps, rss), c in zip(got, ref, cams):
        assert img.shape == (3, c.height, c.width)
        np.testing.assert_allclose(img, rimg, rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose([l1, ps, ss], [rl1, rps, rss], rtol=1e-5)
        assert img.std() > 1e-3
