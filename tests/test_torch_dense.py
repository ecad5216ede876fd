"""The port's dense oracle (``gs_deformable_tpu_torch/ops/rasterize_dense.py``)
against JAX's, the golden arrays, the NumPy oracle and the port's tile path.

- Against ``gs_deformable_tpu/ops/rasterize_dense.py`` on seeded screen-space
  scenes that each exercise one rule (equal-depth ties, gaussians cut by
  their tile rect, pixels ended by first-hit termination), all over a
  non-zero background: colour and final_T at rtol 1e-6 / atol 1e-7 (the
  golden bars, tests/test_golden.py:30-32), n_contrib exact; gradients of a
  fixed cotangent (torch.autograd vs jax.grad) at rtol 5e-4 /
  atol 2e-5 x the leaf's max |g| (tests/test_rasterize.py:98).
- Against ``tests/golden/dense_oracle.npz`` at tests/test_golden.py:30-46's
  bars.  The golden gradients are JAX's float32 sums, and the port sums in
  another order: an element off the gradient bar must lie nearer the
  float64 oracle's gradient than the golden element does.
- Against ``tests/oracle_numpy.py`` as tests/test_second_oracle.py holds JAX.
- The port's CPU tile path (``ops.rasterize.rasterize_arrays``, the plain
  versions of the kernels) against the port's dense oracle at the render
  bars: image rtol 1e-4 / atol 2e-5, final_T atol 2e-6, n_contrib exact
  with the tile cull off (the cull drops instances from the tile lists that
  n_contrib indexes), gradients as above.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops.rasterize_dense import rasterize_dense as jax_dense
from gs_deformable_tpu_torch.config import RasterizeConfig
from gs_deformable_tpu_torch.ops import projection, transforms
from gs_deformable_tpu_torch.ops.rasterize import rasterize_arrays
from gs_deformable_tpu_torch.ops.rasterize_dense import CompositeParams, rasterize_dense

from oracle_numpy import composite_backward_np, composite_forward_np
from test_rasterize import H as GOLDEN_H
from test_rasterize import W as GOLDEN_W
from test_rasterize import make_scene as golden_scene
import test_second_oracle

W, H = 64, 48
BG = np.asarray([0.2, 0.1, 0.5], np.float32)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dense_oracle.npz")
CASES = ["ties", "off_rect", "saturated"]


def screen_scene(case, seed=0, n=80):
    """Screen-space arrays (means2d, depths, conics, opacities, colors, rect,
    mask) of one seeded scene; ``case`` adds the rule it exercises."""
    rng = np.random.default_rng(seed)
    means2d = rng.uniform(-5, [W + 5, H + 5], (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 10.0, n).astype(np.float32)
    a = rng.uniform(0.01, 0.8, n)
    c = rng.uniform(0.01, 0.8, n)
    b = rng.uniform(-0.9, 0.9, n) * np.sqrt(a * c)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    if case == "ties":  # a quarter of the scene at one depth: emission order decides
        depths[: n // 4] = depths[0]
    if case == "saturated":  # a stack of near-opaque wide splats over the centre
        k = 10
        opac[:k] = 0.995
        means2d[:k] = np.asarray([W / 2, H / 2]) + rng.uniform(-2, 2, (k, 2))
        a[:k] = c[:k] = 0.01
        b[:k] = 0.0
        mask[:k] = True
    conics = np.stack([a, b, c], -1).astype(np.float32)
    r = np.ceil(3.0 / np.sqrt(np.minimum(a, c)))
    gx, gy = (W + 15) // 16, (H + 15) // 16
    rect = np.stack([np.clip((means2d[:, 0] - r) // 16, 0, gx),
                     np.clip((means2d[:, 1] - r) // 16, 0, gy),
                     np.clip((means2d[:, 0] + r) // 16 + 1, 0, gx),
                     np.clip((means2d[:, 1] + r) // 16 + 1, 0, gy)], -1).astype(np.int32)
    if case == "off_rect":
        # Every other rect cut to the tile that holds its centre, and a few
        # moved off the centre entirely: falloff past the rect never lands.
        tile = np.clip(means2d // 16, 0, [gx - 1, gy - 1]).astype(np.int32)
        cut = np.arange(n) % 2 == 0
        rect[cut] = np.concatenate([tile, tile + 1], -1)[cut]
        far = np.arange(n) % 7 == 1
        col = (tile[far, 0] + 2) % gx
        rect[far] = np.stack([col, tile[far, 1], col + 1, tile[far, 1] + 1], -1)
    return means2d, depths, conics, opac, colors, rect, mask


def port_dense(arrays, bg=BG, width=W, height=H):
    return rasterize_dense(*(torch.from_numpy(np.array(a)) for a in arrays),
                           torch.from_numpy(np.array(bg)), width=width, height=height)


def assert_forward(got, color, final_t, n_contrib, color_atol=1e-7):
    np.testing.assert_allclose(got.color.numpy(), np.asarray(color), rtol=1e-6,
                               atol=color_atol, err_msg="color")
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(final_t), rtol=1e-6,
                               atol=1e-7, err_msg="final_T")
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.asarray(n_contrib),
                                  err_msg="n_contrib")


def port_grads(arrays, gc, gt, fn=None):
    """d(sum(color * gc) + sum(final_T * gt)) / d(means2d, conics, opacities,
    colors) through torch.autograd; ``fn`` renders (default: the dense oracle)."""
    leaves = [torch.from_numpy(np.array(arrays[k])).requires_grad_(True) for k in (0, 2, 3, 4)]
    ins = [leaves[0], torch.from_numpy(np.array(arrays[1])), leaves[1], leaves[2], leaves[3],
           *(torch.from_numpy(np.array(a)) for a in arrays[5:])]
    fn = fn or (lambda *x: rasterize_dense(*x, torch.from_numpy(BG), width=W, height=H)[:2])
    color, final_t = fn(*ins)
    loss = (color * torch.from_numpy(gc)).sum() + (final_t * torch.from_numpy(gt)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def assert_grads_close(got, ref, rtol=5e-4, atol=2e-5):
    for name, a, b in zip(["means2d", "conics", "opacity", "colors"], got, ref, strict=True):
        b = np.asarray(b)
        assert np.isfinite(a).all(), name
        scale = float(np.abs(b).max()) + 1e-8
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale, err_msg=name)


def cotangents(seed=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, H, W)).astype(np.float32),
            rng.normal(size=(H, W)).astype(np.float32))


def test_composite_params_defaults():
    r = RasterizeConfig()
    assert CompositeParams() == (16, 16, 0.99, 1.0 / 255.0, 1e-4)
    assert CompositeParams() == (r.tile_x, r.tile_y, r.alpha_max, r.alpha_min,
                                 r.transmittance_eps)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax(case):
    arrays = screen_scene(case)
    ref = jax_dense(*(jnp.asarray(a) for a in arrays), jnp.asarray(BG), width=W, height=H)
    got = port_dense(arrays)
    assert_forward(got, ref.color, ref.final_t, ref.n_contrib)
    if case == "saturated":  # first-hit termination ended pixels: T stuck in [1e-4, 1e-2)
        assert float(got.final_t.min()) < 3e-4
    if case == "ties":
        assert len(np.unique(arrays[1])) < len(arrays[1])
    if case == "off_rect":  # the rect decides: whole rects give another image
        whole = port_dense(screen_scene("plain"))
        assert not torch.allclose(whole.color, got.color, atol=1e-3)
    # the background shows where light passes
    assert float(got.final_t.max()) > 0.5


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax(case):
    arrays = screen_scene(case, seed=4)
    gc, gt = cotangents()

    def loss(m2d, con, op, col):
        out = jax_dense(m2d, jnp.asarray(arrays[1]), con, op, col, jnp.asarray(arrays[5]),
                        jnp.asarray(arrays[6]), jnp.asarray(BG), width=W, height=H)
        return jnp.sum(out.color * gc) + jnp.sum(out.final_t * gt)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(arrays[k]) for k in (0, 2, 3, 4)))
    assert_grads_close(port_grads(arrays, gc, gt), ref)


def test_matches_golden():
    g = np.load(GOLDEN)
    pre, opac, colors, _ = golden_scene(np.random.default_rng(0), n=200)
    arrays = [np.asarray(x) for x in (pre.means2d_pix, pre.depths, pre.conics, opac, colors,
                                      pre.rect, pre.mask)]
    bg = np.asarray([0.15, 0.3, 0.45], np.float32)
    out = port_dense(arrays, bg, GOLDEN_W, GOLDEN_H)
    assert_forward(out, g["color"], g["final_t"], g["n_contrib"])

    def grads(dtype):
        leaves = [torch.from_numpy(np.array(arrays[k])).to(dtype).requires_grad_(True)
                  for k in (0, 2, 3, 4)]
        o = rasterize_dense(leaves[0], torch.from_numpy(np.array(arrays[1])).to(dtype),
                            *leaves[1:], *(torch.from_numpy(np.array(a)) for a in arrays[5:]),
                            torch.from_numpy(bg).to(dtype), width=GOLDEN_W, height=GOLDEN_H)
        loss = (o.color ** 2).sum() + (o.final_t ** 2).sum()
        return [x.double().numpy() for x in torch.autograd.grad(loss, leaves)]

    got, exact = grads(torch.float32), grads(torch.float64)
    for a, e, key in zip(got, exact, ["g_means2d", "g_conics", "g_opac", "g_colors"]):
        ref = g[key].astype(np.float64)
        off = np.abs(a - ref) > 1e-6 + 1e-5 * np.abs(ref)
        assert off.mean() <= 0.01, (key, int(off.sum()))
        assert (np.abs(a - e)[off] <= np.abs(ref - e)[off]).all(), key
        np.testing.assert_allclose(a[~off], ref[~off], rtol=1e-5, atol=1e-6, err_msg=key)


def test_forward_matches_numpy_oracle():
    arrays = test_second_oracle.make_scene()
    img, t, nc = composite_forward_np(*arrays, BG, width=test_second_oracle.W,
                                      height=test_second_oracle.H)
    out = port_dense(arrays, BG, test_second_oracle.W, test_second_oracle.H)
    assert float(out.final_t.min()) < 3e-4  # termination exercised
    assert_forward(out, img, t, nc, color_atol=1e-6)  # tests/test_second_oracle.py:75


def test_gradients_match_numpy_oracle():
    arrays = test_second_oracle.make_scene(seed=3)
    w, h = test_second_oracle.W, test_second_oracle.H
    rng = np.random.default_rng(9)
    gc = rng.uniform(-1, 1, (3, h, w)).astype(np.float32)
    gt = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    ref = composite_backward_np(*arrays, gc, gt, width=w, height=h)
    got = port_grads(arrays, gc, gt, lambda *x: rasterize_dense(
        *x, torch.zeros(3), width=w, height=h)[:2])
    for name, a, b in zip(["means2d", "conics", "opacity", "colors"], got, ref, strict=True):
        scale = max(float(np.abs(a).max()), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, rtol=0, atol=2e-6, err_msg=name)


def projected_scene(seed, n=160):
    """Screen-space arrays through the port's own preprocess (3-sigma rects)."""
    rng = np.random.default_rng(seed)
    fovx, fovy = 0.9, 0.7
    view = np.eye(4, dtype=np.float32)
    full = view @ transforms.projection_matrix(0.01, 100.0, fovx, fovy)
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(np.float32)
    means[: n // 8, 2] = 4.0  # depth ties
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.2).astype(np.float32)
    opac = rng.uniform(0.2, 0.99, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    pre = projection.preprocess(
        torch.from_numpy(means), transforms.build_cov3d(torch.from_numpy(s), torch.from_numpy(q)),
        torch.from_numpy(view), torch.from_numpy(full), width=W, height=H,
        tan_fovx=float(np.tan(fovx / 2)), tan_fovy=float(np.tan(fovy / 2)))
    return ([x.numpy() for x in (pre.means2d_pix, pre.depths, pre.conics)] + [opac, colors]
            + [pre.rect.numpy(), pre.mask.numpy()], pre.tiles_touched)


@pytest.mark.parametrize("cull", [False, True])
def test_tile_path_matches_dense(cull):
    arrays, touched = projected_scene(5)
    cfg = RasterizeConfig(instance_capacity=8192, chunk=8, tile_cull=cull)
    dense = port_dense(arrays)

    def tiled(m2d, depths, con, op, col, rect, _mask):
        return rasterize_arrays(m2d, depths, con, op, col, rect, touched, torch.from_numpy(BG),
                                width=W, height=H, cfg=cfg)

    with torch.no_grad():
        img, t, nc, req, _ = tiled(*(torch.from_numpy(np.array(a)) for a in arrays))
    assert int(req) <= cfg.instance_capacity
    np.testing.assert_allclose(img.numpy(), dense.color.numpy(), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(t.numpy(), dense.final_t.numpy(), rtol=1e-4, atol=2e-6)
    if not cull:
        np.testing.assert_array_equal(nc.numpy(), dense.n_contrib.numpy())
    assert float(dense.final_t.min()) < 0.05  # a dense scene: most light is absorbed somewhere
    gc, gt = cotangents(11)
    assert_grads_close(port_grads(arrays, gc, gt, lambda *x: tiled(*x)[:2]),
                       port_grads(arrays, gc, gt))
