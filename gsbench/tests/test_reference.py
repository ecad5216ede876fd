"""The reference against itself on tiny scenes: its blend against a plain
front-to-back loop, its pixel boxes against every pixel of every tile, and
its blocks against one block."""

import math

import pytest
import torch

from gsbench import harness, scene
from gsbench.reference import render as R
from gsbench.session import Base


def tiny_screen(seed, n=60, width=40, height=24, cell="offset-render-1080p"):
    c = harness.load("cells", cell)
    cfg = harness.load("configs", c["config"])
    mix = {**harness.load("traffic", c["traffic"]), "gaussians": n, "capacity": 2 * n}
    s = Base(cfg, mix, seed, "cpu")
    s.make_scene()
    v = scene.view_arrays(scene.arc_c2w(0.1, 0.05), 0.3, width, height, mix["fovx"])
    g = {k: x.clone().requires_grad_(True) for k, x in s.gaussians().items()}
    a = R.deformed(cfg, s.nets_ref, g, v.time, R.stated(cfg))
    sc = R.screen_space(a, R.view_tensors(v, "cpu"), 3, R.stated(cfg))
    # grow the splats so that pixels see long lists and stop early
    sc = sc._replace(conics=sc.conics * 0.02, opacity=torch.clamp(sc.opacity * 6.0, max=0.9),
                     rect=torch.stack([torch.zeros_like(sc.rect[:, 0]),
                                       torch.zeros_like(sc.rect[:, 1]),
                                       torch.full_like(sc.rect[:, 2], (width + 15) // 16),
                                       torch.full_like(sc.rect[:, 3], (height + 15) // 16)],
                                      -1))
    return sc, v, g


def loop_blend(sc, width, height):
    """Front to back over the depth-sorted gaussians, every pixel at once."""
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                            torch.arange(width, dtype=torch.float32), indexing="ij")
    T = torch.ones(height, width)
    C = torch.zeros(3, height, width)
    done = torch.zeros(height, width, dtype=torch.bool)
    for g in torch.sort(sc.depths, stable=True).indices.tolist():
        if not bool(sc.visible[g]):
            continue
        dx, dy = sc.means2d[g, 0] - xs, sc.means2d[g, 1] - ys
        a, b, c = sc.conics[g]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = torch.clamp(sc.opacity[g] * torch.exp(power), max=R.ALPHA_MAX)
        live = ~done & (power <= 0) & (alpha >= R.ALPHA_MIN)
        test = T * (1 - alpha)
        stop = live & (test < R.T_EPS)
        use = live & ~stop
        done = done | stop
        C = C + torch.where(use, alpha * T, 0.0) * sc.colors[g][:, None, None]
        T = torch.where(use, test, T)
    return C, T


@pytest.mark.parametrize("seed", [1, 2])
def test_blend_matches_a_front_to_back_loop(seed):
    sc, v, g = tiny_screen(seed)
    bg = torch.tensor([0.2, 0.5, 0.7])
    img = R.image(sc, R.view_tensors(v, "cpu"), bg, R.stated({"compute_dtype": "float32"}))
    C, T = loop_blend(sc, v.width, v.height)
    ref = C + T * bg[:, None, None]
    assert float((T < 0.5).float().mean()) > 0.2  # many pixels stop early
    torch.testing.assert_close(img, ref, rtol=1e-5, atol=1e-5)
    gi = torch.autograd.grad(img.square().sum(), list(g.values()), allow_unused=True,
                             retain_graph=True)
    gr = torch.autograd.grad(ref.square().sum(), list(g.values()), allow_unused=True)
    for a, b in zip(gi, gr):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4 * float(b.abs().max()))


def test_pixel_boxes_keep_every_pair_that_blends():
    for seed in (3, 4):
        sc, v, _ = tiny_screen(seed, n=200)
        sc = sc._replace(conics=sc.conics * 4.0)  # small splats: boxes much smaller than tiles
        with torch.no_grad():
            p = R.plan(sc, v.width, v.height)
            I = p.gid.shape[0]
            tile = torch.repeat_interleave(torch.arange(len(p.tile_start) - 1),
                                           p.tile_start[1:] - p.tile_start[:-1])
            pix = torch.arange(R.NPIX)
            gg = p.gid[:, None].expand(I, R.NPIX).reshape(-1)
            tt = tile[:, None].expand(I, R.NPIX).reshape(-1)
            pp = pix[None].expand(I, R.NPIX).reshape(-1)
            px = (tt % p.grid_x) * 16 + pp % 16
            py = (tt // p.grid_x) * 16 + pp // 16
            pw, al = R._alpha(sc.means2d, sc.conics, sc.opacity, gg, px.float(), py.float())
            full = (px < v.width) & (py < v.height) & (pw <= 0) & (al >= R.ALPHA_MIN)
            in_box = ((px >= p.box[:, 0].repeat_interleave(R.NPIX))
                      & (px < (p.box[:, 0] + p.box[:, 2]).repeat_interleave(R.NPIX))
                      & (py >= p.box[:, 1].repeat_interleave(R.NPIX))
                      & (py < (p.box[:, 1] + p.box[:, 3]).repeat_interleave(R.NPIX)))
        assert bool((in_box | ~full).all())
        assert int(in_box.sum()) < I * R.NPIX // 4


def test_blocks_give_one_block_s_image_counts_and_gradients():
    sc, v, g = tiny_screen(5)
    vt = R.view_tensors(v, "cpu")
    bg = torch.zeros(3)
    prec = R.stated({"compute_dtype": "float32"})
    outs = []
    for max_pairs in (R.MAX_PAIRS, 700):
        p = R.plan(sc, v.width, v.height, max_pairs=max_pairs)
        work = R.new_work(sc.means2d.shape[0], "cpu")
        rgb, final = R.Composite.apply(sc.means2d, sc.conics, sc.opacity, sc.colors, p, work)
        grads = torch.autograd.grad((rgb * 1.7).sum() + final.sum(), list(g.values()),
                                    allow_unused=True, retain_graph=True)
        outs.append((len(p.blocks), rgb, final, grads, work))
    assert outs[0][0] == 1 and outs[1][0] > 2
    torch.testing.assert_close(outs[0][1], outs[1][1])
    torch.testing.assert_close(outs[0][2], outs[1][2])
    for a, b in zip(outs[0][3], outs[1][3]):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(a.abs().max()))
    w0, w1 = outs[0][4], outs[1][4]
    for k in ("needed_pairs", "walked", "walked_bwd", "contributing"):
        assert w0[k] == w1[k] and w0[k] > 0
    assert bool((w0["touched"] == w1["touched"]).all())
    assert w0["walked"] >= w0["walked_bwd"] and w0["walked"] >= w0["contributing"]
    del vt, bg, prec


def test_rounding_kinds():
    x = torch.tensor([1.0 + 2 ** -12, -3.0000002, 1e-3, 300.0])
    assert torch.equal(R.rnd(x, "float32"), x)
    tf = R.rnd(x, "tf32")
    assert float(tf[0]) == 1.0 and float(tf[1]) == -3.0
    assert float((R.rnd(x, "bfloat16") - x).abs().max()) <= 300 * 2 ** -8
    f8 = R.rnd(x, "float8")
    assert float(f8[3]) == pytest.approx(300.0, rel=1 / 16)
    assert R.control({"compute_dtype": "bfloat16"}) == R.Precision("float8", "tf32", "bfloat16")
    assert R.control({"compute_dtype": "float32"}).net == "tf32"
    assert math.isfinite(float(f8.sum()))
