"""The composite's warp cull (``ops/kernels/composite.py:warp_mask``, the
mirror of ``csrc/composite_common.cuh:warp_keeps``), on the CPU.

The cull gives each (instance, tile) an 8-bit mask, bit w set when the
instance may contribute to a pixel of warp w (the tile's 4 x 8 pixel block
at row 4 (w // 2), column 8 (w % 2)).  It
must be conservative: every pair that passes the composite's skip tests
(power <= 0 and alpha >= alpha_min) lies in a warp whose bit is set, and the
plain forward and backward give bitwise the same output with and without it.
The scenes are built to sit on the cull's edges: opacity within 1e-6 of
alpha_min, long thin rotated conics that cross warp blocks, near-degenerate
and indefinite conics, centres off the tile and on row boundaries, alpha
clamped at alpha_max; plus the port's composite test scenes.
"""

import numpy as np
import pytest
import torch

from gs_deformable_tpu_torch.config import RasterizeConfig
from gs_deformable_tpu_torch.ops.kernels import composite as tcomp
from gs_deformable_tpu_torch.ops.rasterize import prepare_tiles
from test_torch_composite import GX, GY, screen_scene
from test_torch_kernels_cuda import cull_scene

AMIN = 1.0 / 255.0
KINDS = ["knife_opacity", "elongated", "degenerate", "off_tile", "row_boundary",
         "clamped", "mixed", "non_finite"]


def passing_pairs(splats_t, starts, counts, grid_x, chunk):
    """Per tile: (instance rows (9, n), (n, NPIX) bool of pairs that pass the
    composite's skip tests), with the plain version's float operations."""
    px, py = tcomp._pixel_coords(counts.shape[0], grid_x, splats_t.device)
    for t in range(counts.shape[0]):
        s = splats_t[:9, starts[t] * chunk: starts[t] * chunk + counts[t]]
        xg, yg, ca, cb, cc, op = (s[f][:, None] for f in range(6))
        dx, dy = xg - px[t], yg - py[t]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.fmin(torch.tensor(0.99), op * torch.exp(power))
        yield t, s, (power <= 0.0) & (alpha >= AMIN)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_cull_keeps_every_passing_pair(kind, seed):
    chunk = 4
    splats_t, starts, counts, gx = cull_scene(seed, kind, chunk=chunk)
    n_pass = 0
    for t, s, passes in passing_pairs(splats_t, starts, counts, gx, chunk):
        n = s.shape[1]
        px0 = torch.full((n,), float((t % gx) * 16))
        py0 = torch.full((n,), float((t // gx) * 16))
        mask = tcomp.warp_mask(s, px0, py0, AMIN)
        kept = ((mask[:, None] >> tcomp.WARP_OF_PIXEL[None, :]) & 1).bool()
        assert not bool((passes & ~kept).any()), f"tile {t}: a passing pair was culled"
        n_pass += int(passes.sum())
    assert n_pass > 0


@pytest.mark.parametrize("kind", KINDS)
def test_plain_forward_and_backward_bitwise_with_cull(kind):
    chunk = 4
    splats_t, starts, counts, gx = cull_scene(10 + KINDS.index(kind), kind, chunk=chunk)
    kw = dict(grid_x=gx, chunk=chunk)
    out, work = tcomp.composite_forward_plain(splats_t, starts, counts, count_work=True, **kw)
    culled = tcomp.composite_forward_plain(splats_t, starts, counts, warp_cull=True, **kw)
    assert torch.equal(out, culled)
    assert work.contributing > 0
    assert work.warps_contributing <= work.warps_kept <= work.warps_walked
    assert work.contributing <= work.evaluated_kept <= work.evaluated
    rng = np.random.default_rng(3)
    grad = torch.zeros_like(out)
    grad[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4, 256)).astype(np.float32))
    rows = tcomp.composite_backward_plain(splats_t, starts, counts, out, grad, **kw)
    rows_c = tcomp.composite_backward_plain(splats_t, starts, counts, out, grad, warp_cull=True,
                                            **kw)
    assert torch.equal(rows.view(torch.int32), rows_c.view(torch.int32))  # NaNs included
    assert float(rows.nan_to_num().abs().max()) > 0


@pytest.mark.parametrize("opaque", [False, True], ids=["translucent", "opaque"])
@pytest.mark.parametrize("seed", [7, 21])  # the scenes of test_torch_composite{,_bwd}.py
def test_plain_bitwise_with_cull_on_port_scenes(seed, opaque):
    args = screen_scene(seed + opaque, opaque=opaque)
    chunk = 8
    cfg = RasterizeConfig(instance_capacity=4096, chunk=chunk)
    splats_t, binning = prepare_tiles(*(torch.from_numpy(np.array(a)) for a in args),
                                      grid_x=GX, grid_y=GY, cfg=cfg)
    tables = (binning.tile_chunk_start, binning.tile_count)
    kw = dict(grid_x=GX, chunk=chunk)
    out, work = tcomp.composite_forward_plain(splats_t, *tables, count_work=True, **kw)
    assert torch.equal(out, tcomp.composite_forward_plain(splats_t, *tables, warp_cull=True,
                                                          **kw))
    assert work.warps_kept < work.warps_walked  # the cull drops warps on real scenes
    rng = np.random.default_rng(5 + opaque)
    grad = torch.zeros_like(out)
    grad[:, 0:4] = torch.from_numpy(rng.normal(size=(out.shape[0], 4, 256)).astype(np.float32))
    rows, bwork = tcomp.composite_backward_plain(splats_t, *tables, out, grad, count_work=True,
                                                 **kw)
    assert torch.equal(rows, tcomp.composite_backward_plain(splats_t, *tables, out, grad,
                                                            warp_cull=True, **kw))
    assert bwork.evaluated == int(out[:, 4].sum())  # the kernel's walk: up to n_contrib
    assert bwork.contributing == work.contributing


def test_cull_edge_cases():
    # rows [x, y, a, b, c, op] of six instances in the tile at (16, 32)
    s = torch.tensor([
        [20.0, 40.0, 0.5, 0.0, 0.5, AMIN * (1 - 1e-6)],   # below alpha_min: exact, no bit
        [20.0, 40.0, 0.5, 0.0, 0.5, AMIN],                 # at alpha_min: its own row only
        [20.0, 40.0, 0.5, 0.0, 0.5, float("nan")],         # NaN: every bit
        [20.0, 40.0, 0.5, 0.9, 0.5, 0.5],                  # indefinite: every bit
        [20.0, 40.0, 0.0, 0.0, 0.5, 0.5],                  # flat in x: every bit
        [20.0, 100.0, 0.5, 0.0, 0.5, 0.99],                # far below the tile: no bit
    ]).t()
    n = s.shape[1]
    mask = tcomp.warp_mask(s, torch.full((n,), 16.0), torch.full((n,), 32.0), AMIN)
    assert mask.tolist() == [0, 1 << 4, 0xFF, 0xFF, 0xFF, 0]


def test_cull_rows_of_a_round_splat():
    # A round splat at (8, 7.5) with q <= 2 ln(0.5 * 255) + 0.02 ~ 9.73 reaches
    # |d| <= sqrt(9.73 / 0.5) ~ 4.41: pixel rows 4..11 (rows 3 and 12 lie
    # 4.5 away, just out), so the warps of row blocks 1 and 2, both columns
    s = torch.tensor([[8.0, 7.5, 0.5, 0.0, 0.5, 0.5]]).t()
    mask = int(tcomp.warp_mask(s, torch.zeros(1), torch.zeros(1), AMIN))
    thr = 2 * np.log(0.5 / AMIN) + tcomp.CULL_SLACK

    def gap(v, lo, hi):  # distance from v to [lo, hi]
        return max(lo - v, 0.0, v - hi)

    want = 0
    for w in range(8):
        r0, c0 = 4 * (w // 2), 8 * (w % 2)
        if 0.5 * (gap(8.0, c0, c0 + 7) ** 2 + gap(7.5, r0, r0 + 3) ** 2) <= thr:
            want |= 1 << w
    assert mask == want == 0b00111100
