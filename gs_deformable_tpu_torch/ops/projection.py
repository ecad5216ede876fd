"""Per-gaussian screen-space preprocessing (port of ``gs_deformable_tpu/ops/projection.py``).

Every epsilon and clamp of the reference is kept:

- near cull at view z <= 0.2;
- w-epsilon 1e-7 in the perspective divide;
- 1.3 * tan_fov clamp of the EWA Jacobian input;
- +0.3 low-pass on the 2D diagonal;
- radius = ceil(nsigma * sqrt(max eig)) with a 0.1 floor under the sqrt, and
  the opacity-aware nsigma = min(3, sqrt(max(2 ln(255 op) + 0.02, 0)))
  intersected with the reference 3-sigma rect;
- ndc2pix(v, S) = ((v + 1) S - 1) / 2;
- tile rect by floor-div with clamping.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels import tile_cull as _tile_cull

NEAR_Z = 0.2
W_EPS = 1e-7
LOWPASS = 0.3


class PreprocessOut(NamedTuple):
    means2d_ndc: torch.Tensor  # (P, 2)
    means2d_pix: torch.Tensor  # (P, 2)
    depths: torch.Tensor  # (P,) view-space z
    conics: torch.Tensor  # (P, 3) inverse 2D covariance (A, B, C)
    radii: torch.Tensor  # (P,) int32, 0 = culled
    rect: torch.Tensor  # (P, 4) int32 [x0, y0, x1, y1)
    tiles_touched: torch.Tensor  # (P,) int32
    mask: torch.Tensor  # (P,) bool


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _near_test(means3d: torch.Tensor, viewmatrix: torch.Tensor):
    """(view-space z, z > NEAR_Z): the near cull that ``preprocess`` and
    ``mark_visible`` share, so the two cannot disagree."""
    p_view_z = means3d @ viewmatrix[:3, 2] + viewmatrix[3, 2]
    return p_view_z, p_view_z > NEAR_Z


def mark_visible(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                 projmatrix: torch.Tensor) -> torch.Tensor:
    """Standalone visibility test, (P, 3) -> (P,) bool, on the inputs' device.

    The rasterizer's third public entry point (``markVisible``): view z >
    0.2, the near test of ``preprocess``'s cull (the reference's NDC bound
    checks are dead code, so visibility reduces to it).  ``projmatrix`` is
    taken for the reference's signature and unused.
    """
    del projmatrix
    with torch.no_grad():
        return _near_test(means3d, viewmatrix)[1]


def tile_ellipse_mask(means2d_pix, conics, opacities, rect, tiles_touched, *,
                      tile_x: int, tile_y: int, max_bits: int = 16,
                      slack: float = 0.02):
    """Exact per-tile ellipse cull for gaussians whose rect holds <= 16 tiles.

    Returns (mask_code, new_tiles_touched): ``mask_code`` (P,) int32 has bit
    16 set where the mask applies and bits 0..15 flag the surviving rect
    slots (slot i = tile (x0 + i mod w, y0 + i div w)).  CPU tensors take
    the loop ``tile_ellipse_mask_plain``; CUDA tensors one launch of
    ``ops/kernels/tile_cull.py``, bitwise that loop on the card.
    """
    return _tile_cull.tile_cull(means2d_pix, conics, opacities, rect, tiles_touched,
                                tile_x=tile_x, tile_y=tile_y, max_bits=max_bits, slack=slack)


def tile_ellipse_mask_plain(means2d_pix, conics, opacities, rect, tiles_touched, *,
                            tile_x: int, tile_y: int, max_bits: int = 16,
                            slack: float = 0.02):
    """``tile_ellipse_mask`` as a loop of elementwise ops, on any device."""
    if max_bits > 16:
        raise ValueError("max_bits must be <= 16")
    op = opacities[:, 0] if opacities.dim() == 2 else opacities
    x0, y0, x1 = rect[:, 0], rect[:, 1], rect[:, 2]
    w = torch.clamp(x1 - x0, min=1)
    a_c, b_c, c_c = conics[:, 0], conics[:, 1], conics[:, 2]
    usable = (tiles_touched > 0) & (tiles_touched <= max_bits)
    usable = usable & (a_c > 0.0) & (c_c > 0.0)
    qthr = 2.0 * torch.log(torch.clamp(255.0 * op, min=1.0)) + slack
    gx, gy = means2d_pix[:, 0], means2d_pix[:, 1]

    def q_at(dx, dy):
        return a_c * dx * dx + 2.0 * b_c * dx * dy + c_c * dy * dy

    mask = torch.zeros_like(tiles_touched)
    count = torch.zeros_like(tiles_touched)
    for i in range(max_bits):
        iy = i // w
        ix = i - iy * w
        px0 = ((x0 + ix) * tile_x).to(torch.float32)
        py0 = ((y0 + iy) * tile_y).to(torch.float32)
        ax = gx - (px0 + (tile_x - 1))
        bx = gx - px0
        ay = gy - (py0 + (tile_y - 1))
        by = gy - py0
        inside = (ax <= 0.0) & (bx >= 0.0) & (ay <= 0.0) & (by >= 0.0)

        def edge_x(dxv):
            return q_at(dxv, torch.clamp(-b_c * dxv / c_c, ay, by))

        def edge_y(dyv):
            return q_at(torch.clamp(-b_c * dyv / a_c, ax, bx), dyv)

        qmin = torch.minimum(torch.minimum(edge_x(ax), edge_x(bx)),
                             torch.minimum(edge_y(ay), edge_y(by)))
        qmin = torch.where(inside, 0.0, qmin)
        keep = ((i < tiles_touched) & (qmin <= qthr)).to(torch.int32)
        mask = mask | (keep << i)
        count = count + keep
    mask_code = torch.where(usable, mask | (1 << 16), 0).to(torch.int32)
    new_tiles = torch.where(usable, count, tiles_touched).to(torch.int32)
    return mask_code, new_tiles


def compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx, tan_fovy):
    """EWA projection of the packed 3D covariance: (P, 3) [c00, c01, c11] after +0.3."""
    t = means3d @ viewmatrix[:3, :3] + viewmatrix[3, :3]
    tz = t[:, 2]
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    a00 = focal_x * inv_z
    a02 = -focal_x * tx * inv_z2
    a11 = focal_y * inv_z
    a12 = -focal_y * ty * inv_z2

    xx, xy, xz, yy, yz, zz = (cov3d[:, i] for i in range(6))
    sg = ((xx, xy, xz), (xy, yy, yz), (xz, yz, zz))
    tmp = [[sum(viewmatrix[j, i] * sg[j][k] for j in range(3)) for k in range(3)]
           for i in range(3)]

    def scam(i, l):
        return sum(tmp[i][k] * viewmatrix[k, l] for k in range(3))

    s00, s01, s02 = scam(0, 0), scam(0, 1), scam(0, 2)
    s11, s12, s22 = scam(1, 1), scam(1, 2), scam(2, 2)
    c00 = a00 * (a00 * s00 + a02 * s02) + a02 * (a00 * s02 + a02 * s22) + LOWPASS
    c01 = a11 * (a00 * s01 + a02 * s12) + a12 * (a00 * s02 + a02 * s22)
    c11 = a11 * (a11 * s11 + a12 * s12) + a12 * (a11 * s12 + a12 * s22) + LOWPASS
    return torch.stack([c00, c01, c11], dim=-1)


def preprocess(means3d, cov3d, viewmatrix, projmatrix, *, width: int, height: int,
               tan_fovx: float, tan_fovy: float, tile_x: int = 16, tile_y: int = 16,
               alive: Optional[torch.Tensor] = None,
               opacities: Optional[torch.Tensor] = None) -> PreprocessOut:
    """Project all gaussians to screen space and count the tiles each touches.

    ``alive`` masks dead capacity slots like frustum-culled gaussians;
    ``opacities`` (activated) turns on the opacity-aware radius.
    """
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y

    p_view_z, in_front = _near_test(means3d, viewmatrix)
    p_hom = means3d @ projmatrix[:3, :] + projmatrix[3, :]
    p_w = 1.0 / (p_hom[:, 3] + W_EPS)
    ndc = p_hom[:, :2] * p_w[:, None]

    cov2d = compute_cov2d(means3d, cov3d, viewmatrix, focal_x, focal_y, tan_fovx, tan_fovy)
    c00, c01, c11 = cov2d[:, 0], cov2d[:, 1], cov2d[:, 2]
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([c11 * det_inv, -c01 * det_inv, c00 * det_inv], dim=-1)

    pix = torch.stack([ndc2pix(ndc[:, 0], width), ndc2pix(ndc[:, 1], height)], dim=-1)

    # Radius and tile rect are integers with no gradient; built without
    # autograd, as JAX's zero derivative of ceil/floor prunes this branch (a
    # recorded sqrt(0) or log(0) here would turn its zero cotangent into NaN).
    with torch.no_grad():
        mid = 0.5 * (c00 + c11)
        lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        lam2 = mid - torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        if opacities is not None:
            op = opacities[:, 0] if opacities.dim() == 2 else opacities
            nsigma = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * op) + 0.02, min=0.0))
            nsigma = torch.clamp(nsigma, max=3.0)
        else:
            nsigma = 3.0
        sqrt_lam = torch.sqrt(torch.maximum(lam1, lam2))
        radius_f = torch.ceil(nsigma * sqrt_lam)

        def clip_i32(v, hi):
            return torch.clamp(v, 0, hi).to(torch.int32)

        x0 = clip_i32(torch.floor((pix[:, 0] - radius_f) / tile_x), grid_x)
        y0 = clip_i32(torch.floor((pix[:, 1] - radius_f) / tile_y), grid_y)
        if opacities is not None:
            # floor((p + r)/TILE) + 1 is the exclusive bound for a float centre;
            # intersecting with the reference 3-sigma rect keeps its coverage.
            r3 = torch.ceil(3.0 * sqrt_lam)
            x1 = torch.minimum(torch.floor((pix[:, 0] + radius_f) / tile_x) + 1,
                               torch.floor((pix[:, 0] + r3 + tile_x - 1) / tile_x))
            y1 = torch.minimum(torch.floor((pix[:, 1] + radius_f) / tile_y) + 1,
                               torch.floor((pix[:, 1] + r3 + tile_y - 1) / tile_y))
        else:
            x1 = torch.floor((pix[:, 0] + radius_f + tile_x - 1) / tile_x)
            y1 = torch.floor((pix[:, 1] + radius_f + tile_y - 1) / tile_y)
        x1 = clip_i32(x1, grid_x)
        y1 = clip_i32(y1, grid_y)
        ntiles = (x1 - x0) * (y1 - y0)

    mask = in_front & det_ok & (ntiles > 0)
    if alive is not None:
        mask = mask & alive
    radii = torch.where(mask, radius_f, 0.0).to(torch.int32)
    tiles_touched = torch.where(mask, ntiles, 0).to(torch.int32)
    rect = torch.stack([x0, y0, x1, y1], dim=-1)
    return PreprocessOut(ndc, pix, p_view_z, conics, radii, rect, tiles_touched, mask)
