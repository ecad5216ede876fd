"""Port parity: the plain tile composite vs the JAX mixed forward (Pallas, interpret mode).

Both sides take the same screen-space inputs, so they bin identically and
composite the same splats.  Bars: rgb rtol 1e-4 / atol 2e-5, final_T atol
2e-6, n_contrib exact.  The JAX transmittance is a tree-ordered prefix
product and the port's a sequential loop, so T differs at ~1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.config import RasterizeConfig as JRasterizeConfig
from gs_deformable_tpu.ops import projection as jproj
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu.ops.rasterize import composite_tiles as jcomposite
from gs_deformable_tpu_torch.config import RasterizeConfig
from gs_deformable_tpu_torch.ops.kernels import composite as tcomp
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.ops.rasterize import composite_tiles

W, H = 80, 48
GX, GY = (W + 15) // 16, (H + 15) // 16


def screen_scene(seed, n=200, opaque=False):
    rng = np.random.default_rng(seed)
    fovx, fovy = 0.9, 0.7
    view = np.eye(4, dtype=np.float32)
    full = view @ jtf.projection_matrix(0.01, 100.0, fovx, fovy)
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    logs = rng.normal(size=(n, 3)) * 0.5 - (1.6 if opaque else 2.4)
    s = np.exp(logs).astype(np.float32)
    lo, hi = (0.9, 0.999) if opaque else (0.2, 0.98)
    opac = rng.uniform(lo, hi, n).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    pre = jproj.preprocess(
        jnp.asarray(means), jtf.build_cov3d(jnp.asarray(s), jnp.asarray(q)),
        jnp.asarray(view), jnp.asarray(full), width=W, height=H,
        tan_fovx=np.tan(fovx / 2), tan_fovy=np.tan(fovy / 2), opacities=jnp.asarray(opac))
    args = (pre.means2d_pix, pre.depths, pre.conics, jnp.asarray(opac), jnp.asarray(colors),
            pre.rect, pre.tiles_touched)
    return args


def assert_tiles_close(got, ref):
    """(T, 8, 256) composite rows held to the reference bars."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[:, 0:3], ref[:, 0:3], rtol=1e-4, atol=2e-5, err_msg="rgb")
    np.testing.assert_allclose(got[:, 3], ref[:, 3], rtol=0, atol=2e-6, err_msg="final_T")
    np.testing.assert_array_equal(got[:, 4], ref[:, 4], err_msg="n_contrib")


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("chunk,cull", [(8, False), (16, True)])
def test_composite_matches_jax_mixed_forward(opaque, chunk, cull):
    args = screen_scene(7 + opaque, opaque=opaque)
    jcfg = JRasterizeConfig(instance_capacity=4096, chunk=chunk, tile_cull=cull,
                            composite_mode="mixed", sort_mode="exact")
    ref, jreq, _ = jcomposite(*args, grid_x=GX, grid_y=GY, cfg=jcfg, interpret=True)
    cfg = RasterizeConfig(instance_capacity=4096, chunk=chunk, tile_cull=cull)
    before = launch_counts()
    got, req, _ = composite_tiles(*(torch.from_numpy(np.array(a)) for a in args),
                                  grid_x=GX, grid_y=GY, cfg=cfg)
    assert launch_counts() == before
    assert int(req) == int(jreq) <= 4096
    assert got.shape == (GX * GY, 8, 256)
    assert_tiles_close(got, ref)
    if opaque:  # early termination really happened: some pixel stopped with T < 1e-3
        t_final = got[:, 3]
        assert float(t_final.min()) < 1e-3


def test_composite_empty_tiles():
    # Empty tiles give rgb 0, T 1, n 0; padding rows past count are never read.
    splats = torch.full((16, 64), float("nan"))
    start = torch.tensor([0, 1, 2], dtype=torch.int32)
    count = torch.zeros(3, dtype=torch.int32)
    out = tcomp.composite_forward(splats, start, count, grid_x=3, chunk=16)
    assert torch.equal(out[:, 3], torch.ones(3, 256))
    assert torch.equal(out[:, [0, 1, 2, 4, 5, 6, 7]], torch.zeros(3, 7, 256))


def test_composite_work_count():
    splats = torch.zeros(16, 8)
    splats[0:2] = 8.0  # centred on pixel (8, 8) of tile 0
    splats[2], splats[4], splats[5] = 1e-6, 1e-6, 1.0  # flat, opaque
    splats[6:9] = 1.0
    res, work = tcomp.composite_forward_plain(
        splats, torch.tensor([0], dtype=torch.int32), torch.tensor([8], dtype=torch.int32),
        grid_x=1, chunk=8, alpha_max=0.999, count_work=True)
    # every pixel blends instance 1 (T -> 1e-3), then stops at instance 2;
    # each of the 8 warps walks both, the cull keeps both (a flat splat
    # reaches every row), and each warp holds a contributing lane at the first
    assert work == tcomp.Work(evaluated=2 * 256, contributing=256, evaluated_kept=2 * 256,
                              warps_walked=16, warps_kept=16, warps_contributing=8)
    assert torch.equal(res[0, 4], torch.ones(256))
