"""Port parity: the packed schedule (``composite_mode="packed"``,
``sort_mode="packed"``) and ``make_chunk_step`` vs the JAX package.

The JAX Pallas kernels run in interpret mode.  Shapes are the reference's
own (tests/test_rasterize.py:205-208): an 80x48 frame with chunk 8 and
sub_chunk 2 and 4, plus chunk 128 with sub_chunk 32.  Bars:

- binning: every ``Binning`` field bitwise, ties and overflow included;
- forward: images rtol 1e-4 / atol 2e-5, final_T atol 2e-6, n_contrib
  exact;
- gradients (means2d, conics, opacity, colours): rtol 5e-4 / atol 3e-5 x
  the leaf's max |g|, the reference's packed-vs-batch bar
  (test_rasterize.py:232);
- the port's packed and mixed schedules on the CPU: bitwise equal (one
  kernel walks the same instances in the same order; only the row offsets
  differ);
- ``make_chunk_step``: the slice-2 bars of tests/test_torch_train_step.py.

Knife-edge rule.  The JAX packed kernel decides contribution through a
log-space prefix (probe = exp(cumsum(log1p(-alpha))) >= eps), the port
through the sequential T * (1 - alpha) < eps of the CUDA reference.  At a
pixel whose T sits within ulps of eps the two can keep one splat more or
less.  Where JAX's packed result leaves the forward bars against JAX's own
"batch" result, the port must meet them against "batch" instead; gradients
of the gaussians in such a pixel's tile are then held to "batch" too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu import config as jconfig
from gs_deformable_tpu import training as jtraining
from gs_deformable_tpu.ops import projection as jproj
from gs_deformable_tpu.ops.binning import bin_gaussians as jbin
from gs_deformable_tpu.ops.rasterize import rasterize_arrays as jrasterize
from gs_deformable_tpu.renderer import CameraArrays as JCameraArrays
from gs_deformable_tpu_torch import config, convert, training
from gs_deformable_tpu_torch.ops import binning as tbin
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.ops.rasterize import prepare_tiles, rasterize_arrays
from gs_deformable_tpu_torch.renderer import CameraArrays
from test_torch_binning import GX, GY, _assert_bitwise, screen_inputs
from test_torch_composite import H, W, screen_scene
from test_torch_train_step import STEP_KW, configs, leaves, scene, to_port

LAYOUTS = [(8, 2), (8, 4), (128, 32)]  # (chunk, sub_chunk)
BG = np.asarray([0.25, 0.5, 0.75], np.float32)
GRAD_NAMES = ("means2d", "conics", "opacity", "colors")


def test_layout_unit():
    assert config.layout_unit(config.RasterizeConfig()) == 128
    assert config.layout_unit(config.RasterizeConfig(composite_mode="packed")) == 32
    assert config.layout_unit(config.RasterizeConfig(
        composite_mode="packed", chunk=8, sub_chunk=2)) == 2
    assert config.layout_unit(config.RasterizeConfig(sort_mode="packed", sub_chunk=4)) == 128


# --- binning -------------------------------------------------------------


def _bin_both(tt, rect, depths, mask=None, **kw):
    """JAX and port ``bin_gaussians`` on the same numpy / JAX inputs."""
    ref = jbin(jnp.asarray(tt), jnp.asarray(rect), jnp.asarray(depths), tile_mask=None
               if mask is None else jnp.asarray(mask), fill_mode="pallas_all", **kw)
    got = tbin.bin_gaussians(*(torch.from_numpy(np.array(a)) for a in (tt, rect, depths)),
                             tile_mask=None if mask is None else torch.from_numpy(np.array(mask)),
                             **kw)
    return ref, got


@pytest.mark.parametrize("sort_mode", ["packed", "exact"])
@pytest.mark.parametrize("unit", [2, 4, 32])
@pytest.mark.parametrize("cull", [False, True])
def test_binning_bitwise(sort_mode, unit, cull):
    pre, opac = screen_inputs(31 + unit)
    tt, mask = pre.tiles_touched, None
    if cull:
        mask, tt = jproj.tile_ellipse_mask(pre.means2d_pix, pre.conics, opac, pre.rect, tt,
                                           tile_x=16, tile_y=16)
    ref, got = _bin_both(tt, pre.rect, pre.depths, mask, grid_x=GX, grid_y=GY, capacity=4096,
                         chunk=unit, sort_mode=sort_mode)
    assert 0 < int(ref.required) <= 4096
    _assert_bitwise(ref, got)


def near_tie_inputs(seed, P=300, gx=7, gy=5):
    """Rects on a small grid and depths within 0.05% of 4.0: their top 19
    bits mostly agree, so the packed key's emission-order tiebreak decides."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, gx, P), rng.integers(0, gy, P)
    x1 = np.minimum(x0 + rng.integers(1, 4, P), gx)
    y1 = np.minimum(y0 + rng.integers(1, 4, P), gy)
    tt = np.where(rng.random(P) < 0.2, 0, (x1 - x0) * (y1 - y0)).astype(np.int32)
    rect = np.stack([x0, y0, x1, y1], -1).astype(np.int32)
    depths = (4.0 * (1.0 + rng.uniform(0.0, 5e-4, P))).astype(np.float32)
    return tt, rect, depths


def _gid_in_tiles(b, unit):
    return [b.gid[int(s) * unit: int(s) * unit + int(c)].tolist()
            for s, c in zip(b.tile_chunk_start, b.tile_count)]


def test_binning_near_depth_ties_bitwise():
    tt, rect, depths = near_tie_inputs(41)
    kw = dict(grid_x=7, grid_y=5, capacity=2048, chunk=4)
    ref, got = _bin_both(tt, rect, depths, sort_mode="packed", **kw)
    _assert_bitwise(ref, got)
    exact = tbin.bin_gaussians(*(torch.from_numpy(a) for a in (tt, rect, depths)),
                               sort_mode="exact", **kw)
    # The truncated key really reorders ties: some tile's order differs from
    # the exact depth order, while every tile holds the same gaussians.
    packed_tiles, exact_tiles = _gid_in_tiles(got, 4), _gid_in_tiles(exact, 4)
    assert packed_tiles != exact_tiles
    assert [sorted(t) for t in packed_tiles] == [sorted(t) for t in exact_tiles]


@pytest.mark.parametrize("cull", [False, True])
def test_binning_overflow_bitwise(cull):
    pre, opac = screen_inputs(11, n=400)
    tt, mask = pre.tiles_touched, None
    if cull:
        mask, tt = jproj.tile_ellipse_mask(pre.means2d_pix, pre.conics, opac, pre.rect, tt,
                                           tile_x=16, tile_y=16)
    kw = dict(grid_x=GX, grid_y=GY, capacity=200, chunk=4)
    ref, got = _bin_both(tt, pre.rect, pre.depths, mask, sort_mode="packed", **kw)
    assert int(got.required) > 200 and int(got.num_instances) == 200
    _assert_bitwise(ref, got)
    # Index-order truncation keeps other instances than the exact mode's
    # depth-order truncation.
    _, exact = _bin_both(tt, pre.rect, pre.depths, mask, sort_mode="exact", **kw)
    assert not torch.equal(got.gid, exact.gid)


def test_binning_packed_rejects_large_grid():
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="8192"):
        tbin.bin_gaussians(z, torch.zeros((4, 4), dtype=torch.int32), torch.ones(4),
                           grid_x=128, grid_y=64, capacity=8, chunk=4, sort_mode="packed")


# --- forward and gradients against JAX ------------------------------------


@functools.partial(jax.jit, static_argnames="cfg")
def _jax_value_and_grad(args, wimg, cfg):
    means, depths, conics, opac, colors, rect, tt = args

    def loss(m, c, o, col):
        img, ft, nc, _, _ = jrasterize(m, depths, c, o, col, rect, tt, jnp.asarray(BG),
                                       width=W, height=H, cfg=cfg)
        return jnp.sum(img * wimg), (img, ft, nc)

    return jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        means, conics, opac, colors)


def _jax_render(args, wimg, cfg):
    """JAX image, final_T, n_contrib and the gradients of sum(image * wimg)."""
    (_, (img, ft, nc)), grads = _jax_value_and_grad(tuple(args), jnp.asarray(wimg), cfg)
    return [np.asarray(x) for x in (img, ft, nc)], [np.asarray(g) for g in grads]


def _port_render(args, wimg, cfg):
    t = [torch.from_numpy(np.array(a)) for a in args]
    xs = [t[i].requires_grad_(True) for i in (0, 2, 3, 4)]
    img, ft, nc, _, _ = rasterize_arrays(xs[0], t[1], xs[1], xs[2], xs[3], t[5], t[6],
                                         torch.from_numpy(BG), width=W, height=H, cfg=cfg)
    grads = torch.autograd.grad((img * torch.from_numpy(np.asarray(wimg))).sum(), xs)
    return [x.detach().numpy() for x in (img, ft, nc)], [g.numpy() for g in grads]


def _off_bar(got, ref):
    """(H, W) bool: pixels where ``got`` leaves the forward bars against ``ref``."""
    (gi, gf, gn), (ri, rf, rn) = got, ref
    img_off = (np.abs(gi - ri) > 2e-5 + 1e-4 * np.abs(ri)).any(axis=0)
    return img_off | (np.abs(gf - rf) > 2e-6) | (gn != rn)


@pytest.fixture(scope="module", params=[(opaque, lay) for opaque in (False, True)
                                        for lay in LAYOUTS],
                ids=lambda p: f"{'opaque' if p[0] else 'translucent'}-{p[1][0]}-{p[1][1]}")
def packed_case(request):
    opaque, (chunk, sub) = request.param
    args = screen_scene(51 + opaque + sub, n=180, opaque=opaque)
    wimg = np.random.default_rng(sub + opaque).normal(size=(3, H, W)).astype(np.float32)
    jcfg = jconfig.RasterizeConfig(instance_capacity=4096, chunk=chunk, sub_chunk=sub,
                                   stream_chunks=3, composite_mode="packed", sort_mode="exact")
    cfg = config.RasterizeConfig(instance_capacity=4096, chunk=chunk, sub_chunk=sub,
                                 composite_mode="packed")
    before = launch_counts()
    port = _port_render(args, wimg, cfg)
    assert launch_counts() == before  # CPU tensors never launch a kernel
    return dict(jp=_jax_render(args, wimg, jcfg), port=port, opaque=opaque, args=args,
                wimg=wimg, cfg=cfg, jcfg=jcfg, sub=sub)


def knife_edges(case):
    """Knife-edge pixels (JAX packed off the forward bars against JAX batch),
    the gaussians with an instance in their tiles, and JAX batch's result.

    Only called where the port leaves the bars against JAX packed: JAX's
    "batch" compile is the slowest part of this file."""
    if "knife" not in case:
        args = case["args"]
        jb = _jax_render(args, case["wimg"], dataclasses.replace(case["jcfg"],
                                                                 composite_mode="batch"))
        knife = _off_bar(case["jp"][0], jb[0])
        _, binning = prepare_tiles(*(torch.from_numpy(np.array(a)) for a in args),
                                   grid_x=GX, grid_y=GY, cfg=case["cfg"])
        tiles = np.pad(knife, ((0, GY * 16 - H), (0, GX * 16 - W))).reshape(GY, 16, GX, 16)
        gauss = np.zeros(args[0].shape[0], bool)
        for t in np.flatnonzero(tiles.any(axis=(1, 3)).reshape(-1)):
            s = int(binning.tile_chunk_start[t]) * case["sub"]
            gauss[binning.gid[s: s + int(binning.tile_count[t])].numpy()] = True
        print(f"knife-edge pixels (JAX packed vs JAX batch): {int(knife.sum())}")
        case.update(knife=knife, knife_gauss=gauss, jb=jb)
    return case["knife"], case["knife_gauss"], case["jb"]


def test_forward_matches_jax_packed(packed_case):
    c = packed_case
    (pi, pf, pn), jp = c["port"][0], c["jp"][0]
    off = _off_bar(c["port"][0], jp)
    if off.any():
        k, _, jb = knife_edges(c)
        (ji, jf, jn), (bi, bf, bn) = jp, jb[0]
        np.testing.assert_allclose(pi[:, ~k], ji[:, ~k], rtol=1e-4, atol=2e-5, err_msg="image")
        np.testing.assert_allclose(pf[~k], jf[~k], rtol=0, atol=2e-6, err_msg="final_T")
        np.testing.assert_array_equal(pn[~k], jn[~k], err_msg="n_contrib")
        # At knife-edge pixels the port is the sequential reference: JAX "batch".
        np.testing.assert_allclose(pi[:, k], bi[:, k], rtol=1e-4, atol=2e-5, err_msg="image")
        np.testing.assert_allclose(pf[k], bf[k], rtol=0, atol=2e-6, err_msg="final_T")
        np.testing.assert_array_equal(pn[k], bn[k], err_msg="n_contrib")
    assert pn.max() > 0
    if c["opaque"]:
        assert float(pf.min()) < 1e-3  # pixels terminated early


def _grads_close(got, ref):
    scale = np.abs(ref).max() + 1e-30
    return np.abs(got - ref) <= 3e-5 * scale + 5e-4 * np.abs(ref)


def test_gradients_match_jax_packed(packed_case):
    c = packed_case
    grads = list(zip(GRAD_NAMES, c["port"][1], c["jp"][1]))
    if not all(_grads_close(got, jp).all() for _, got, jp in grads):
        _, kg, jb = knife_edges(c)
        grads = [(name, got, np.where(kg.reshape((-1,) + (1,) * (jp.ndim - 1)), b, jp))
                 for (name, got, jp), b in zip(grads, jb[1])]
    for name, got, ref in grads:
        scale = np.abs(ref).max() + 1e-30
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=3e-5 * scale, err_msg=name)
        assert np.abs(got).max() > 0, name


@pytest.mark.parametrize("grad_reduce", ["sort", "scatter"])
def test_port_packed_equals_mixed_bitwise(packed_case, grad_reduce):
    c = packed_case
    outs = [_port_render(c["args"], c["wimg"], dataclasses.replace(
        c["cfg"], composite_mode=mode, grad_reduce=grad_reduce)) for mode in ("packed", "mixed")]
    (fp, gp), (fm, gm) = outs
    for name, a, b in zip(("image", "final_T", "n_contrib") + GRAD_NAMES, fp + gp, fm + gm):
        np.testing.assert_array_equal(a, b, err_msg=name)


# --- make_chunk_step against JAX ------------------------------------------


CHUNK_MAX, N_STEPS, IT0 = 3, 2, 7


def _stack_cams(view, full, times):
    j = JCameraArrays(jnp.stack([jnp.asarray(view)] * CHUNK_MAX),
                      jnp.stack([jnp.asarray(full)] * CHUNK_MAX), jnp.zeros((CHUNK_MAX, 3)),
                      jnp.asarray(times))
    t = CameraArrays(torch.from_numpy(np.stack([view] * CHUNK_MAX)),
                     torch.from_numpy(np.stack([full] * CHUNK_MAX).astype(np.float32)),
                     torch.zeros((CHUNK_MAX, 3)), torch.from_numpy(times))
    return j, t


def _chunk_both(raster):
    jcfg = dataclasses.replace(configs(jconfig, compute_dtype="float32"),
                               raster=jconfig.RasterizeConfig(**raster))
    cfg = dataclasses.replace(configs(config, compute_dtype="float32"),
                              raster=config.RasterizeConfig(**raster))
    state, view, full, gt = scene()
    times = np.asarray([0.4, 0.55, 0.7], np.float32)
    jcams, tcams = _stack_cams(view, full, times)
    rng = np.random.default_rng(8)
    gts = np.stack([gt] + [rng.uniform(0, 1, gt.shape).astype(np.float32)
                           for _ in range(CHUNK_MAX - 1)])
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(state, seed=0, cfg=jcfg))
    jrun = jtraining.make_chunk_step(jcfg, **STEP_KW, chunk_max=CHUNK_MAX)
    jts, jm = jrun(jax.tree_util.tree_map(jnp.array, init), jcams, jnp.asarray(gts),
                   jnp.zeros(3), jnp.asarray(IT0), jnp.asarray(N_STEPS))
    trun = training.make_chunk_step(cfg, **STEP_KW, chunk_max=CHUNK_MAX, device="cpu")
    tts, tm = trun(to_port(init, cfg), tcams, torch.from_numpy(gts), torch.zeros(3), IT0,
                   N_STEPS)
    return dict(jax=jax.tree_util.tree_map(np.asarray, jts), jm={k: np.asarray(v) for k, v in
                                                                 jm.items()},
                port=convert.train_state_to_numpy(tts), tm={k: v.numpy() for k, v in tm.items()},
                cfg=cfg, init=init, tcams=tcams, gts=gts)


@pytest.fixture(scope="module")
def chunk_run():
    return _chunk_both(dict(instance_capacity=2048, chunk=8, sub_chunk=2,
                            composite_mode="packed"))


def test_chunk_step_matches_jax(chunk_run):
    r = chunk_run
    assert set(r["tm"]) == set(r["jm"])
    for name in ("loss", "ll1", "ssim", "offset_norm", "psnr"):
        np.testing.assert_allclose(r["tm"][name], r["jm"][name], rtol=1e-5, err_msg=name)
    for key in ("required_instances", "required_aligned", "n_alive", "overflow_frames"):
        assert int(r["tm"][key]) == int(r["jm"][key]), key
    assert int(r["tm"]["overflow_frames"]) == 0
    # After two steps mu = 0.1 g2 + 0.09 g1 and nu = 0.001 (g2^2 + 0.999 g1^2).
    for moment in ("mu", "nu"):
        jl, tl = leaves(getattr(r["jax"].adam, moment)), leaves(r["port"]["adam"][moment])
        assert [n for n, _ in jl] == [n for n, _ in tl]
        for (name, ref), (_, got) in zip(jl, tl):
            if moment == "nu":
                ref, got = np.sqrt(ref / 0.001), np.sqrt(got / 0.001)
            scale = np.abs(ref).max() + 1e-30
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=5e-5 * scale,
                                       err_msg=f"{moment} {name}")
    assert r["port"]["adam"]["step"] == int(r["jax"].adam.step) == N_STEPS


def test_chunk_step_equals_single_steps(chunk_run):
    r = chunk_run
    step = training.make_train_step(r["cfg"], **STEP_KW, device="cpu")
    ts = to_port(r["init"], r["cfg"])
    for i in range(N_STEPS):
        cam = CameraArrays(*(x[i] for x in r["tcams"]))
        ts, m = step(ts, cam, torch.from_numpy(r["gts"][i]), torch.zeros(3), IT0 + i)
    got = convert.train_state_to_numpy(ts)
    for part in ("gaussians", "adam"):
        for (name, a), (_, b) in zip(leaves(got[part]), leaves(r["port"][part]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=f"{part}{name}")
    for (name, a), (_, b) in zip(leaves(got["deform"]), leaves(r["port"]["deform"])):
        np.testing.assert_array_equal(a, b, err_msg=f"deform{name}")
    for k in ("loss", "ll1", "ssim", "psnr", "offset_norm"):
        assert float(m[k]) == float(r["tm"][k]), k


def test_chunk_step_overflow_counts_match_jax():
    # Capacity below the frame's need: every step overflows by instances.
    # Worst-case slack (-1) keeps the aligned rows inside both Kp sizes.
    r = _chunk_both(dict(instance_capacity=64, chunk=8, sub_chunk=4, composite_mode="packed"))
    for key in ("required_instances", "required_aligned", "overflow_frames"):
        assert int(r["tm"][key]) == int(r["jm"][key]), key
    assert int(r["tm"]["required_instances"]) > 64
    assert int(r["tm"]["overflow_frames"]) == N_STEPS
    np.testing.assert_allclose(r["tm"]["loss"], r["jm"]["loss"], rtol=1e-5)


def test_chunk_step_zero_steps():
    cfg = configs(config, compute_dtype="float32")
    run = training.make_chunk_step(cfg, **STEP_KW, chunk_max=CHUNK_MAX, device="cpu")
    state, view, full, gt = scene()
    init = jax.tree_util.tree_map(np.asarray, jtraining.init_train_state(
        state, seed=0, cfg=configs(jconfig, compute_dtype="float32")))
    ts = to_port(init, cfg)
    _, tcams = _stack_cams(view, full, np.zeros(CHUNK_MAX, np.float32))
    gts = torch.from_numpy(np.stack([gt] * CHUNK_MAX))
    before = convert.train_state_to_numpy(ts)
    ts, m = run(ts, tcams, gts, torch.zeros(3), IT0, 0)
    assert all(float(v) == 0 for v in m.values())
    for (name, a), (_, b) in zip(leaves(before["gaussians"]),
                                 leaves(convert.train_state_to_numpy(ts)["gaussians"])):
        np.testing.assert_array_equal(a, b, err_msg=name)
    with pytest.raises(ValueError):
        run(ts, tcams, gts, torch.zeros(3), IT0, CHUNK_MAX + 1)


def test_chunk_step_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        training.make_chunk_step(configs(config), **STEP_KW)
