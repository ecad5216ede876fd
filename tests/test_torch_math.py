"""Port parity: transforms, spherical harmonics and preprocess vs the JAX package.

Float outputs are held to fp32 rounding (rtol 1e-5 / atol 1e-6: the two
frameworks order a few sums differently); integer outputs (radii, tile
rects, counts) must match exactly on these scenes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_deformable_tpu.ops import projection as jproj
from gs_deformable_tpu.ops import sh as jsh
from gs_deformable_tpu.ops import transforms as jtf
from gs_deformable_tpu_torch.ops import projection as tproj
from gs_deformable_tpu_torch.ops import sh as tsh
from gs_deformable_tpu_torch.ops import transforms as ttf


def close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _quats(rng, n):
    return rng.normal(size=(n, 4)).astype(np.float32)


def test_transforms_match_jax():
    rng = np.random.default_rng(0)
    q = _quats(rng, 64)
    s = np.exp(rng.normal(size=(64, 3)) - 2).astype(np.float32)
    close(ttf.quat_to_rotmat(torch.from_numpy(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
    for mod in (1.0, 0.7):
        close(ttf.build_cov3d(torch.from_numpy(s), torch.from_numpy(q), mod),
              jtf.build_cov3d(jnp.asarray(s), jnp.asarray(q), mod))
    R = jtf.quat_to_rotmat(jnp.asarray(q[0] / np.linalg.norm(q[0])))
    t = rng.normal(size=3)
    np.testing.assert_array_equal(
        ttf.world_to_view(np.asarray(R, np.float64), t, np.array([0.1, 0, 0]), 1.5),
        jtf.world_to_view(np.asarray(R, np.float64), t, np.array([0.1, 0, 0]), 1.5))
    np.testing.assert_array_equal(ttf.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                  jtf.projection_matrix(0.01, 100.0, 0.9, 0.7))
    assert ttf.fov2focal(0.9, 800) == jtf.fov2focal(0.9, 800)
    assert ttf.focal2fov(500.0, 800) == jtf.focal2fov(500.0, 800)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    n, K = 50, (deg + 1) ** 2
    sh = rng.normal(size=(n, K, 3)).astype(np.float32)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    campos = rng.normal(size=3).astype(np.float32)
    dirs = means / np.linalg.norm(means, axis=-1, keepdims=True)
    close(tsh.eval_sh(deg, torch.from_numpy(sh).transpose(1, 2), torch.from_numpy(dirs)),
          jsh.eval_sh(deg, jnp.swapaxes(jnp.asarray(sh), 1, 2), jnp.asarray(dirs)),
          atol=1e-5)
    close(tsh.eval_sh_color(deg, torch.from_numpy(sh), torch.from_numpy(means),
                            torch.from_numpy(campos)),
          jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos)),
          atol=1e-5)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    close(tsh.rgb2sh(torch.from_numpy(rgb)), jsh.rgb2sh(jnp.asarray(rgb)))
    close(tsh.sh2rgb(torch.from_numpy(rgb)), jsh.sh2rgb(jnp.asarray(rgb)))


@pytest.mark.parametrize("opacity_aware", [False, True])
def test_preprocess_matches_jax(opacity_aware):
    rng = np.random.default_rng(3)
    n, W, H = 300, 80, 48
    fovx, fovy = 0.9, 0.7
    ang = 0.3
    view = np.eye(4, dtype=np.float32)
    view[0, 0] = view[2, 2] = np.cos(ang)
    view[0, 2], view[2, 0] = -np.sin(ang), np.sin(ang)
    view[3, :3] = [0.2, -0.1, 0.5]
    full = view @ ttf.projection_matrix(0.01, 100.0, fovx, fovy)
    means = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(-1.0, 9.0, n)], -1).astype(np.float32)
    q = _quats(rng, n)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(rng.normal(size=(n, 3)) * 0.5 - 2.4).astype(np.float32)
    opac = rng.uniform(0.001, 0.99, n).astype(np.float32)
    alive = rng.random(n) > 0.1
    cov = np.array(jtf.build_cov3d(jnp.asarray(s), jnp.asarray(q)))
    kw = dict(width=W, height=H, tan_fovx=float(np.tan(fovx / 2)),
              tan_fovy=float(np.tan(fovy / 2)))
    ref = jproj.preprocess(jnp.asarray(means), jnp.asarray(cov), jnp.asarray(view),
                           jnp.asarray(full), alive=jnp.asarray(alive),
                           opacities=jnp.asarray(opac) if opacity_aware else None, **kw)
    got = tproj.preprocess(torch.from_numpy(means), torch.from_numpy(cov),
                           torch.from_numpy(view), torch.from_numpy(full),
                           alive=torch.from_numpy(alive),
                           opacities=torch.from_numpy(opac) if opacity_aware else None, **kw)
    m = np.asarray(ref.mask)
    assert m.sum() > 100
    np.testing.assert_array_equal(got.mask.numpy(), m)
    for name in ("radii", "rect", "tiles_touched"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("means2d_ndc", "means2d_pix", "depths"):
        close(getattr(got, name), getattr(ref, name), atol=1e-5)
    close(got.conics.numpy()[m], np.asarray(ref.conics)[m], rtol=1e-4, atol=1e-5)
    cov2d_args = (means, cov, view)
    close(tproj.compute_cov2d(*(torch.from_numpy(a) for a in cov2d_args), 500.0, 400.0,
                              0.45, 0.36)[m],
          np.asarray(jproj.compute_cov2d(*(jnp.asarray(a) for a in cov2d_args), 500.0, 400.0,
                                         0.45, 0.36))[m], rtol=1e-4, atol=1e-4)
    close(tproj.ndc2pix(torch.tensor([-1.0, 0.0, 0.5]), W),
          jproj.ndc2pix(jnp.asarray([-1.0, 0.0, 0.5]), W))


def test_mark_visible_five_points():
    """The five points of tests/test_projection.py::test_mark_visible: the
    near test only, so a point far outside the frustum is visible."""
    view = np.eye(4, dtype=np.float32)
    full = view @ ttf.projection_matrix(0.01, 100.0, 0.8, 0.8)
    means = np.asarray([[0, 0, 0.1], [0, 0, -3.0], [100.0, 0, 5.0], [0, 0, 5.0], [0, 0, 0.2]],
                       np.float32)
    got = tproj.mark_visible(*(torch.from_numpy(a) for a in (means, view, full)))
    ref = jproj.mark_visible(*(jnp.asarray(a) for a in (means, view, full)))
    assert got.dtype == torch.bool and got.shape == (5,)
    np.testing.assert_array_equal(got.numpy(), [False, False, True, True, False])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _seeded_view(rng):
    """A world-to-view matrix (row-vector convention) with a seeded rotation
    and translation."""
    q = rng.normal(size=4)
    R = ttf.quat_to_rotmat(torch.from_numpy((q / np.linalg.norm(q)).astype(np.float32))).numpy()
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = R.T
    view[3, :3] = rng.uniform(-0.5, 0.5, 3)
    return view


def test_mark_visible_cloud_matches_jax():
    """10,000 seeded points around a seeded camera, half of them behind the
    near plane: the port equals JAX at every point whose view z lies more
    than 4 ulps from 0.2 (the two frameworks may order the dot product's
    sum differently); the points within 4 ulps are counted and reported."""
    rng = np.random.default_rng(11)
    view = _seeded_view(rng)
    full = view @ ttf.projection_matrix(0.01, 100.0, 0.9, 0.7)
    means = rng.uniform(-3.0, 3.0, (10_000, 3)).astype(np.float32)
    got = tproj.mark_visible(*(torch.from_numpy(a) for a in (means, view, full))).numpy()
    ref = np.asarray(jproj.mark_visible(*(jnp.asarray(a) for a in (means, view, full))))
    z = means.astype(np.float64) @ view[:3, 2].astype(np.float64) + float(view[3, 2])
    knife = np.abs(z - tproj.NEAR_Z) <= 4 * np.spacing(np.float32(tproj.NEAR_Z))
    print(f"points within 4 ulps of the near plane: {int(knife.sum())}")
    assert 2_000 < got.sum() < 8_000
    np.testing.assert_array_equal(got[~knife], ref[~knife])


def test_mark_visible_knife_edge_equals_preprocess():
    """Points whose view z sits within a few ulps of 0.2, all on screen: the
    port's mark_visible equals its own preprocess mask bitwise (the two share
    one near test), and both sides of the plane occur."""
    rng = np.random.default_rng(12)
    view = _seeded_view(rng)
    fovx, fovy, W, H = 0.9, 0.7, 64, 48
    full = view @ ttf.projection_matrix(0.01, 100.0, fovx, fovy)
    steps = np.arange(-40, 41)
    z = np.float32(tproj.NEAR_Z) + steps.astype(np.float32) * np.spacing(np.float32(0.2))
    p_view = np.stack([rng.uniform(-0.01, 0.01, z.shape[0]),
                       rng.uniform(-0.01, 0.01, z.shape[0]), z], -1).astype(np.float64)
    # p_view = means @ view[:3, :3] + view[3, :3], solved for means
    means = (p_view - view[3, :3]) @ np.linalg.inv(view[:3, :3].astype(np.float64))
    means = means.astype(np.float32)
    s = np.full((z.shape[0], 3), 0.002, np.float32)
    q = np.tile(np.array([[1.0, 0.0, 0.0, 0.0]], np.float32), (z.shape[0], 1))
    t = {k: torch.from_numpy(v) for k, v in dict(means=means, view=view, full=full).items()}
    vis = tproj.mark_visible(t["means"], t["view"], t["full"])
    pre = tproj.preprocess(t["means"], ttf.build_cov3d(torch.from_numpy(s), torch.from_numpy(q)),
                           t["view"], t["full"], width=W, height=H,
                           tan_fovx=float(np.tan(fovx / 2)), tan_fovy=float(np.tan(fovy / 2)))
    assert 0 < int(vis.sum()) < z.shape[0]
    assert torch.equal(vis, pre.mask)
    assert torch.equal(vis, pre.depths > tproj.NEAR_Z)


def test_unpack_cov3d_matches_jax():
    """Bitwise JAX's layout, and the exact inverse of build_cov3d's packing."""
    rng = np.random.default_rng(13)
    q = _quats(rng, 64)
    s = np.exp(rng.normal(size=(64, 3)) - 2).astype(np.float32)
    cov6 = ttf.build_cov3d(torch.from_numpy(s), torch.from_numpy(q)).reshape(4, 16, 6)
    got = ttf.unpack_cov3d(cov6)
    ref = np.asarray(jtf.unpack_cov3d(jnp.asarray(cov6.numpy())))
    assert got.shape == (4, 16, 3, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, got.transpose(-1, -2))
    iu = torch.triu_indices(3, 3)
    assert torch.equal(got[..., iu[0], iu[1]], cov6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_num_sh_coeffs_matches_jax(degree):
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree) == (degree + 1) ** 2
