"""Port parity: the composite backward's plain version vs the JAX VJP (Pallas, interpret mode).

Both sides take the same sorted splats, binning and upstream gradient rows
0-3.  The JAX side runs each schedule whose backward the one CUDA kernel
replaces: "mixed" (stream_composite.py:_stream_backward_kernel), "batch"
(composite.py:_backward_kernel) and "stream" (the stream forward paired
with the same backward).  Bar: rtol 5e-4 / atol 2e-5 x the row's max |g|,
the reference's composite-gradient bar (tests/test_rasterize.py:98); the
same bar after the per-gaussian segment sum ("sort" and "scatter" against
JAX's sort-based ``segment_sum_rows``).  The JAX transmittance is a
tree-ordered prefix product and its prefixes are matmuls, so sums differ
from the port's sequential ones at ~1e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops.pallas.composite import make_tile_composite
from gs_deformable_tpu.ops.pallas.stream_composite import (
    make_mixed_composite,
    make_stream_composite,
)
from gs_deformable_tpu.ops.segsum import segment_sum_rows as jsegment_sum_rows
from gs_deformable_tpu_torch.config import RasterizeConfig
from gs_deformable_tpu_torch.ops import segsum
from gs_deformable_tpu_torch.ops.kernels import composite as tcomp
from gs_deformable_tpu_torch.ops.kernels import launch_counts
from gs_deformable_tpu_torch.ops.rasterize import prepare_tiles
from test_torch_composite import GX, GY, screen_scene
from test_torch_kernels_cuda import in_range_rows

CHUNK = 8


def jax_composite(mode, Kp):
    common = dict(grid_x=GX, grid_y=GY, tile_x=16, tile_y=16, chunk=CHUNK,
                  padded_capacity=Kp, alpha_max=0.99, alpha_min=1.0 / 255.0, eps=1e-4,
                  scan_mode="linear", interpret=True)
    if mode == "mixed":
        return make_mixed_composite(tile_batch=8, stream_chunks=8, defer_reductions=False,
                                    **common)
    if mode == "stream":
        return make_stream_composite(stream_chunks=8, **common)
    return make_tile_composite(tile_batch=8, defer_reductions=False, **common)


def assert_rows_close(got, ref, what):
    """Per field: rtol 5e-4 / atol 2e-5 x max |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    for r in range(ref.shape[0]):
        scale = np.abs(ref[r]).max() + 1e-30
        np.testing.assert_allclose(got[r], ref[r], rtol=5e-4, atol=2e-5 * scale,
                                   err_msg=f"{what} field {r}")


@pytest.fixture(scope="module", params=[False, True], ids=["translucent", "opaque"])
def case(request):
    """Port binning, sorted splats, forward out and backward rows of one scene."""
    opaque = request.param
    args = screen_scene(21 + opaque, opaque=opaque)
    cfg = RasterizeConfig(instance_capacity=4096, chunk=CHUNK)
    splats_t, binning = prepare_tiles(*(torch.from_numpy(np.array(a)) for a in args),
                                      grid_x=GX, grid_y=GY, cfg=cfg)
    T = GX * GY
    rng = np.random.default_rng(5 + opaque)
    grad = np.zeros((T, 8, 256), np.float32)
    grad[:, 0:4] = rng.normal(size=(T, 4, 256))
    tables = (binning.tile_chunk_start, binning.tile_count)
    kw = dict(grid_x=GX, chunk=CHUNK)
    before = launch_counts()
    out = tcomp.composite_forward(splats_t, *tables, **kw)
    rows = tcomp.composite_backward(splats_t, *tables, out, torch.from_numpy(grad), **kw)
    assert launch_counts() == before  # CPU tensors never launch a kernel
    if opaque:
        assert float(out[:, 3].min()) < 1e-3  # pixels terminated early
    return dict(splats_t=splats_t, binning=binning, grad=grad, rows=rows, opaque=opaque,
                P=args[0].shape[0])


@pytest.mark.parametrize("mode", ["mixed", "batch", "stream"])
def test_backward_rows_match_jax(case, mode):
    splats_t, binning = case["splats_t"], case["binning"]
    Kp, T = splats_t.shape[1], GX * GY
    comp = jax_composite(mode, Kp)
    tcs, tc = (jnp.asarray(t.numpy()) for t in (binning.tile_chunk_start, binning.tile_count))
    _, vjp = jax.vjp(lambda s: comp(s, tcs, tc)[:T], jnp.asarray(splats_t.numpy()))
    (ref,) = vjp(jnp.asarray(case["grad"]))
    rows = case["rows"]
    assert rows.shape == (16, Kp)
    assert_rows_close(rows[:9], np.asarray(ref)[:9], f"{mode} rows")
    assert not rows[9:].any() and not np.asarray(ref)[9:].any()


def test_rows_outside_tiles_are_zero(case):
    rows, binning = case["rows"], case["binning"]
    inside = in_range_rows(binning, CHUNK, rows.shape[1])
    assert int(inside.sum()) == int(binning.tile_count.sum())
    assert not rows[:, ~inside].any()
    assert rows[:9, inside].abs().amax(dim=1).min() > 0  # every field is exercised


@pytest.mark.parametrize("grad_reduce", ["sort", "scatter"])
def test_segment_sum_matches_jax(case, grad_reduce):
    rows, gid, P = case["rows"], case["binning"].gid, case["P"]
    ref = jsegment_sum_rows(jnp.asarray(rows.t().numpy()), jnp.asarray(gid.numpy()), P)
    reduce = segsum.segment_sum_rows if grad_reduce == "sort" else segsum.scatter_sum_rows
    got = reduce(rows.t().contiguous(), gid, P)
    assert got.shape == (P, 16)
    assert_rows_close(got.t().numpy(), np.asarray(ref).T, grad_reduce)
    # Gather then reduce: GatherSplatsT's gradient is this sum.
    splats = torch.zeros((P, 16), requires_grad=True)
    (grad,) = torch.autograd.grad(
        segsum.GatherSplatsT.apply(splats, gid, grad_reduce), splats, rows)
    assert torch.equal(grad, got)


def test_segment_sum_sort_is_exact_per_segment():
    # Each total is a sum of only its own rows: a huge neighbour cannot
    # swamp a small segment (differences of a global prefix would).  Zero
    # rows (the layout's padding, gaussian 0) are left out of the sums.
    rows = torch.tensor([[1e8], [3.0], [0.0], [1e-3], [2e-3], [-1e8], [5.0], [0.0]])
    gid = torch.tensor([0, 1, 0, 2, 2, 0, 4, 3], dtype=torch.int32)
    got = segsum.segment_sum_rows(rows, gid, 6)
    assert got[:, 0].tolist() == [0.0, 3.0, np.float32(1e-3) + np.float32(2e-3), 0.0, 5.0, 0.0]
