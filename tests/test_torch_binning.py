"""Port parity: gs_deformable_tpu_torch binning vs the JAX bin_gaussians.

Both binnings take the SAME screen-space inputs (the JAX preprocess and
tile-cull outputs): binning integers are bitwise only when the inputs are,
and a 1-ulp difference upstream could flip a radius ceil.  All six Binning
fields must then agree bit for bit, the unset aligned slots included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops import projection as jproj
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu.ops.binning import bin_gaussians as jbin
from gs_deformable_tpu_torch.ops import binning as tbin
from gs_deformable_tpu_torch.ops.projection import tile_ellipse_mask

W, H = 80, 48
GX, GY = (W + 15) // 16, (H + 15) // 16


def screen_inputs(seed, n=300, ties=False):
    rng = np.random.default_rng(seed)
    fovx, fovy = 0.9, 0.7
    view = np.eye(4, dtype=np.float32)
    full = view @ jtf.projection_matrix(0.01, 100.0, fovx, fovy)
    means = np.stack([rng.uniform(-1.6, 1.6, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(2.5, 9.0, n)], -1).astype(np.float32)
    means[: n // 10, 2] = -1.0  # behind the camera: culled
    if ties:
        means[n // 10: n // 3, 2] = 4.0  # exact depth ties: index tiebreak
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.4).astype(np.float32)
    opac = rng.uniform(0.02, 0.98, n).astype(np.float32)
    pre = jproj.preprocess(
        jnp.asarray(means), jtf.build_cov3d(jnp.asarray(s), jnp.asarray(q)),
        jnp.asarray(view), jnp.asarray(full), width=W, height=H,
        tan_fovx=np.tan(fovx / 2), tan_fovy=np.tan(fovy / 2), opacities=jnp.asarray(opac))
    return pre, jnp.asarray(opac)


def _both(pre, opac, *, cull, chunk, capacity, slack=-1):
    tt, rect, depths = pre.tiles_touched, pre.rect, pre.depths
    mask = None
    if cull:
        mask, tt = jproj.tile_ellipse_mask(pre.means2d_pix, pre.conics, opac, rect, tt,
                                           tile_x=16, tile_y=16)
    kw = dict(grid_x=GX, grid_y=GY, capacity=capacity, chunk=chunk, aligned_slack=slack)
    ref = jbin(tt, rect, depths, sort_mode="exact", tile_mask=mask, fill_mode="pallas_all",
               **kw)
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(tt=tt, rect=rect, depths=depths).items()}
    got = tbin.bin_gaussians(t["tt"], t["rect"], t["depths"], sort_mode="exact",
                             tile_mask=None if mask is None else torch.from_numpy(np.array(mask)),
                             **kw)
    return ref, got


def _assert_bitwise(ref, got):
    for name in tbin.Binning._fields:
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("ties", [False, True])
def test_binning_bitwise(cull, chunk, ties):
    pre, opac = screen_inputs(3 + ties, ties=ties)
    ref, got = _both(pre, opac, cull=cull, chunk=chunk, capacity=4096)
    assert int(ref.required) <= 4096
    _assert_bitwise(ref, got)


@pytest.mark.parametrize("cull", [False, True])
def test_binning_overflow_bitwise(cull):
    pre, opac = screen_inputs(11, n=400)
    ref, got = _both(pre, opac, cull=cull, chunk=8, capacity=200)
    assert int(got.required) > 200  # the deepest instances dropped, surfaced
    assert int(got.num_instances) == 200
    _assert_bitwise(ref, got)


def test_binning_tight_slack_bitwise():
    pre, opac = screen_inputs(12)
    ref, got = _both(pre, opac, cull=True, chunk=16, capacity=592, slack=64)
    Kp = tbin.aligned_capacity(592, GX * GY, 16, 64)
    assert int(got.required) <= 592
    assert got.gid.shape == (Kp,)
    assert int(got.total_aligned) > Kp  # aligned overflow is surfaced
    _assert_bitwise(ref, got)


def test_binning_empty_frame():
    P = 16
    kw = dict(grid_x=GX, grid_y=GY, capacity=64, chunk=8)
    tt = np.zeros(P, np.int32)
    rect = np.zeros((P, 4), np.int32)
    depths = np.linspace(1, 2, P).astype(np.float32)
    ref = jbin(jnp.asarray(tt), jnp.asarray(rect), jnp.asarray(depths), sort_mode="exact",
               fill_mode="pallas_all", **kw)
    got = tbin.bin_gaussians(torch.from_numpy(tt), torch.from_numpy(rect),
                             torch.from_numpy(depths), **kw)
    _assert_bitwise(ref, got)


def test_tile_ellipse_mask_bitwise():
    pre, opac = screen_inputs(5)
    ref = jproj.tile_ellipse_mask(pre.means2d_pix, pre.conics, opac, pre.rect,
                                  pre.tiles_touched, tile_x=16, tile_y=16)
    got = tile_ellipse_mask(*(torch.from_numpy(np.array(a)) for a in (
        pre.means2d_pix, pre.conics, opac, pre.rect, pre.tiles_touched)), tile_x=16, tile_y=16)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_tile_cull_on_cpu_tensors_runs_the_plain_loop(monkeypatch):
    """CPU tensors take the loop itself: no kernel library is loaded, nothing
    is launched, and strided or (P, 1) inputs give the loop's own result."""
    from gs_deformable_tpu_torch.ops import projection as tproj
    from gs_deformable_tpu_torch.ops.kernels import launch_counts
    from gs_deformable_tpu_torch.ops.kernels import tile_cull as tcull

    def no_library():
        raise AssertionError("a CPU call loaded the kernel library")

    monkeypatch.setattr(tcull, "_lib", no_library)
    pre, opac = screen_inputs(6)
    args = [torch.from_numpy(np.array(a)) for a in (
        pre.means2d_pix, pre.conics, opac, pre.rect, pre.tiles_touched)]
    before = launch_counts()
    got = tile_ellipse_mask(*args, tile_x=16, tile_y=16)
    ref = tproj.tile_ellipse_mask_plain(*args, tile_x=16, tile_y=16)
    wide = torch.cat([args[0], args[1], args[2][:, None]], 1)
    strided = tile_ellipse_mask(wide[:, 0:2], wide[:, 2:5], wide[:, 5:6], *args[3:],
                                tile_x=16, tile_y=16)
    assert launch_counts() == before
    for a, b, c in zip(got, ref, strided):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert 0 < int(((got[0] >> 16) & 1).sum()) <= int((args[4] > 0).sum())
    with pytest.raises(ValueError, match="max_bits"):
        tile_ellipse_mask(*args, tile_x=16, tile_y=16, max_bits=17)


@pytest.mark.parametrize("grid", [(7, 5), (100, 90)])
def test_binning_rect_code_widths_bitwise(grid):
    # (100, 90) has >= 2^13 tiles: the 30-bit rect code the JAX fill splits
    # into two fp32 columns; the port fills it as one int32 column.
    gx, gy = grid
    rng = np.random.default_rng(21)
    P = 300
    x0, y0 = rng.integers(0, gx, P), rng.integers(0, gy, P)
    x1 = np.minimum(x0 + rng.integers(1, 4, P), gx)
    y1 = np.minimum(y0 + rng.integers(1, 4, P), gy)
    tt = np.where(rng.random(P) < 0.3, 0, (x1 - x0) * (y1 - y0)).astype(np.int32)
    rect = np.stack([x0, y0, x1, y1], -1).astype(np.int32)
    depths = rng.uniform(0.3, 10.0, P).astype(np.float32)
    depths[::3] = 2.5
    kw = dict(grid_x=gx, grid_y=gy, capacity=1024, chunk=8, aligned_slack=512)
    ref = jbin(jnp.asarray(tt), jnp.asarray(rect), jnp.asarray(depths), sort_mode="exact",
               fill_mode="pallas_all", **kw)
    got = tbin.bin_gaussians(torch.from_numpy(tt), torch.from_numpy(rect),
                             torch.from_numpy(depths), **kw)
    _assert_bitwise(ref, got)
