"""Screen space on the CPU: ``ops.rasterize.screen_space`` runs the plain chain
there (``ops/kernels/screen_space.forward_plain``), bitwise, and the
autograd plumbing of the card's route (``ScreenSpaceFn``: its outputs, the
tap's pair, which inputs get a gradient from which cotangents) holds with
the plain versions standing in for the kernels, as they do for CPU tensors.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from gs_deformable_tpu_torch.config import RasterizeConfig
from gs_deformable_tpu_torch.ops import rasterize
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.ops.kernels import screen_space as ssk

import screen_cases

N, ALIVE, W, H = 300, 240, 96, 64
CPU = torch.device("cpu")


def same(a, b):
    """Bitwise equal, NaNs included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _scene(seed, coeffs=16):
    cam, kw = screen_cases.camera(W, H, CPU)
    x = screen_cases.inputs(seed, N, ALIVE, CPU, coeffs=coeffs)
    screen_cases.edge_rows(x, cam, seed)
    return x, cam, kw


@pytest.mark.parametrize("deg", [0, 3, 4])
@pytest.mark.parametrize("tap", [False, True])
@pytest.mark.parametrize("aware", [False, True])
def test_screen_space_on_cpu_is_the_plain_chain(deg, tap, aware):
    x, cam, kw = _scene(deg, 25 if deg == 4 else 16)
    t = torch.zeros((N, 2)) if tap else None
    before = launch_counts()
    ss = rasterize.screen_space(x["means3d"], x["scales"], x["rotations"], x["opacities"],
                                x["shs"], sh_degree=deg, alive=x["alive"],
                                means2d_offset_ndc=t,
                                cfg=RasterizeConfig(opacity_aware_radius=aware), **cam, **kw)
    assert launch_counts() == before
    ref = dict(zip(ssk.OUTPUTS, ssk.forward_plain(
        x["means3d"], x["scales"], x["rotations"], x["shs"], *cam.values(), sh_degree=deg,
        opacities=x["opacities"] if aware else None, alive=x["alive"], tap=t, **kw)))
    pre = ss.pre
    for got, k in ((pre.means2d_ndc, "ndc"), (pre.means2d_pix, "pix"), (pre.depths, "depths"),
                   (pre.conics, "conics"), (ss.colors, "colors"), (pre.radii, "radii"),
                   (pre.rect, "rect"), (pre.tiles_touched, "tiles_touched"),
                   (pre.mask, "mask"), (ss.means2d_ndc, "ndc_tap" if tap else "ndc"),
                   (ss.means2d_pix, "pix_tap" if tap else "pix")):
        assert same(got, ref[k]), k
    assert ss.opacities is x["opacities"]
    assert bool(pre.mask.any()) and not bool(pre.mask[ALIVE:].any())


@pytest.mark.parametrize("deg", [0, 1, 3])
@pytest.mark.parametrize("which", ["step", "mesh", "colors", "all"])
def test_screen_space_fn_matches_autograd_on_cpu(deg, which):
    """``ScreenSpaceFn`` on CPU tensors (its kernels' plain versions inside):
    values and gradients bitwise autograd through the plain chain; an input
    that no arriving cotangent reaches gets zeros where autograd gives None."""
    names = {"step": ("pix_tap", "conics", "colors"),
             "mesh": ("ndc_tap", "conics", "colors", "depths"),
             "colors": ("colors",), "all": ssk.GRAD_OUTPUTS}[which]
    x, cam, kw = _scene(10 + deg)
    kw = dict(kw, sh_degree=deg, scale_modifier=0.8)
    gen = torch.Generator().manual_seed(deg)

    def run(fn):
        leaves = [x[k].clone().requires_grad_(True) for k in ("means3d", "scales",
                                                              "rotations", "shs")]
        tap = torch.zeros((N, 2), requires_grad=True)
        out = fn(leaves, tap)
        out = dict(zip(ssk.OUTPUTS, out))
        gen.manual_seed(deg)
        pairs = [(out[k], torch.randn(out[k].shape, generator=gen)) for k in ssk.GRAD_OUTPUTS
                 if k in names]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves + [tap],
                                    [g for _, g in pairs], allow_unused=True)
        return out, grads

    camera = tuple(cam.values())
    got_out, got = run(lambda lv, tap: ssk.ScreenSpaceFn.apply(
        *lv, tap, *camera, x["opacities"], x["alive"], dict(kw, tile_x=16, tile_y=16)))
    ref_out, ref = run(lambda lv, tap: ssk.forward_plain(
        *lv, *camera, opacities=x["opacities"], alive=x["alive"], tap=tap, **kw))
    for k in ssk.OUTPUTS:
        assert same(got_out[k], ref_out[k]), k
    for k, g, r in zip(ssk.INPUTS, got, ref):
        assert g is not None, k
        assert not bool(g.any()) if r is None else same(g, r), k
    assert (ref[0] is None) == (which == "colors" and deg == 0)
    assert (ref[4] is None) == (which == "colors")


def test_screen_space_fn_refuses_a_camera_that_wants_a_gradient():
    """The kernels give the camera no gradient, so ``ScreenSpaceFn`` refuses
    a camera that wants one; ``screen_space`` on CPU tensors (the plain
    chain) still differentiates it."""
    cam, kw = screen_cases.camera(W, H, CPU)
    x = screen_cases.inputs(7, N, ALIVE, CPU)
    kw = dict(kw, sh_degree=3)
    for k in cam:
        bad = dict(cam, **{k: cam[k].clone().requires_grad_(True)})
        with pytest.raises(ValueError, match="camera"):
            ssk.ScreenSpaceFn.apply(x["means3d"], x["scales"], x["rotations"], x["shs"], None,
                                    *bad.values(), None, x["alive"],
                                    dict(kw, tile_x=16, tile_y=16))
        ss = rasterize.screen_space(x["means3d"], x["scales"], x["rotations"],
                                    x["opacities"], x["shs"], alive=x["alive"], **bad, **kw)
        live = ss.pre.mask
        out = sum(t[live].sum() for t in (ss.means2d_pix, ss.pre.depths, ss.pre.conics,
                                          ss.colors))
        (g,) = torch.autograd.grad(out, [bad[k]])
        assert bool(torch.isfinite(g).all()) and bool(g.any()), k
