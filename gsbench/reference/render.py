"""One frame of a deformable 3D gaussian scene, in plain PyTorch.

The deformation nets (``DirectTemporalNeRF``: 8 x 256 ReLU trunk, a skip
at layer 4, NeRF positional encodings; the SE(3) variant on raw inputs with
an exponential map; the opacity-mask gate), the activations, the EWA
projection of 3D gaussian splatting with its low-pass filter, the
opacity-aware 3-sigma tile rectangles, SH colour up to degree 3, a stable
(tile, depth, index) order and front-to-back alpha blending per pixel with
3DGS's thresholds (alpha clamped at 0.99, skipped below 1/255, a pixel
stops before the gaussian that would take its transmittance under 1e-4).

The blend is written as sums of log(1 - alpha) along each pixel's list,
over blocks of tiles, so that it runs on a whole frame without a loop per
gaussian.  ``Composite`` recomputes each block in its backward.  Work
counts for the benchmark's rooflines come from the same blocks.

``Precision`` says how each part rounds: the configuration's own
precision, or the next lower one for the control.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

TILE = 16
NPIX = TILE * TILE
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
NEAR_Z = 0.2
W_EPS = 1e-7
LOWPASS = 0.3
MAX_PAIRS = 1 << 24  # (pixel, instance) pairs a block holds

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Precision(NamedTuple):
    """Rounding of the deformation net's matmul operands (``net``), of the
    gate's (``gate``), and of every tensor handed from one stage to the next
    (``rest``).  Kinds: "float32", "tf32", "bfloat16", "float8"."""

    net: str = "bfloat16"
    gate: str = "float32"
    rest: str = "float32"


LOWER = {"float32": "tf32", "tf32": "bfloat16", "bfloat16": "float8"}


def stated(config: dict) -> Precision:
    """The precision the configuration states: its net tier (bf16 operands
    summed in fp32, or fp32), an fp32 gate, fp32 everywhere else; TF32 off."""
    return Precision(net=config["compute_dtype"], gate="float32", rest="float32")


def control(config: dict) -> Precision:
    """One step below each stated precision: fp8 operands for a bf16 tier,
    TF32 operands for an fp32 matmul, bf16 tensors between stages."""
    p = stated(config)
    return Precision(net=LOWER[p.net], gate=LOWER[p.gate], rest="bfloat16")


def pin_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _straight_through(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def rnd(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to ``kind`` and held in fp32."""
    if kind == "float32":
        return x
    if kind == "bfloat16":  # autograd rounds the cotangent at the cast as well
        return x.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        if kind == "tf32":  # 10 explicit mantissa bits, nearest even
            bits = x.contiguous().view(torch.int32)
            bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
            q = bits.view(torch.float32)
        elif kind == "float8":  # e4m3 with one scale per tensor
            s = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
            q = (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
        else:
            raise ValueError(f"unknown precision {kind!r}")
    return _straight_through(x, q)


# --- deformation ---------------------------------------------------------

def posenc(x: torch.Tensor, freqs: int) -> torch.Tensor:
    feats = [x]
    for i in range(freqs):
        feats += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(feats, dim=-1)


def mlp(params: dict, x: torch.Tensor, t: torch.Tensor, skips, kind: str) -> List[torch.Tensor]:
    """Trunk of ReLU layers on cat(x, t), x concatenated in front after each
    layer in ``skips``; one output per head."""
    h = torch.cat([x, t], dim=-1)
    for i, layer in enumerate(params["layers"]):
        h = torch.relu(rnd(h, kind) @ rnd(layer["w"], kind) + layer["b"])
        if i in skips:
            h = torch.cat([x, h], dim=-1)
    hr = rnd(h, kind)
    return [hr @ rnd(hd["w"], kind) + hd["b"] for hd in params["heads"]]


def skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[:, 0])
    return torch.stack([torch.stack([z, -w[:, 2], w[:, 1]], -1),
                        torch.stack([w[:, 2], z, -w[:, 0]], -1),
                        torch.stack([-w[:, 1], w[:, 0], z], -1)], -2)


def se3_move(w: torch.Tensor, v: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """xyz moved by exp([w, v]) with the screw normalised by theta = |w|
    (Modern Robotics 3.88): R xyz + V v / theta."""
    theta = torch.linalg.vector_norm(w, dim=-1)
    safe = torch.clamp(theta, min=1e-12)[:, None]
    K = skew(w / safe)
    K2 = (K[:, :, :, None] * K[:, None, :, :]).sum(2)
    th = theta[:, None, None]
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device).expand_as(K)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * K2
    V = th * eye + (1.0 - torch.cos(th)) * K + (th - torch.sin(th)) * K2
    return (R * xyz[:, None, :]).sum(-1) + (V * (v / safe)[:, None, :]).sum(-1)


class Attributes(NamedTuple):
    means: torch.Tensor  # (n, 3)
    scales: torch.Tensor  # (n, 3)
    rotations: torch.Tensor  # (n, 4) unit
    opacity: torch.Tensor  # (n,)
    shs: torch.Tensor  # (n, K, 3)
    dx: torch.Tensor  # (n, 3) move of the means


def deformed(config: dict, nets: dict, g: dict, time: float, prec: Precision) -> Attributes:
    """Activated attributes at ``time`` of the gaussians ``g`` (raw leaves
    xyz, f_dc, f_rest, opacity, scaling, rotation), past the nets' warm-up."""
    xyz = g["xyz"]
    n = xyz.shape[0]
    t = torch.full((n, 1), float(time), dtype=xyz.dtype, device=xyz.device)
    skips = tuple(config["skips"])
    shs = torch.cat([g["f_dc"], g["f_rest"]], dim=1)
    if config["deform_mode"] == "offset":
        dx, ds, dr, dsh = mlp(nets["net"], posenc(xyz, config["multires_xyz"]),
                              posenc(t, config["multires_time"]), skips, prec.net)
        means = xyz + dx
        scales = torch.exp(g["scaling"] + ds)
        rot = g["rotation"] + dr
        rot = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=-1, keepdim=True), min=1e-12)
        shs = shs + dsh.reshape(shs.shape)
    elif config["deform_mode"] == "se3":
        w, v = mlp(nets["net"], xyz, t, skips, prec.net)
        means = se3_move(w, v, xyz)
        dx = means - xyz
        scales = torch.exp(g["scaling"])
        rot = g["rotation"] / torch.linalg.vector_norm(g["rotation"], dim=-1, keepdim=True)
    else:
        raise ValueError(f"unknown deform_mode {config['deform_mode']!r}")
    opacity = torch.sigmoid(g["opacity"][:, 0])
    if config["use_opacity_mask"]:
        (logit,) = mlp(nets["gate"], xyz, t, skips, prec.gate)
        opacity = opacity * torch.sigmoid(logit[:, 0])
    return Attributes(*(rnd(a, prec.rest) for a in (means, scales, rot, opacity, shs)), dx)


# --- screen space --------------------------------------------------------

class Screen(NamedTuple):
    means2d: torch.Tensor  # (n, 2) pixels
    conics: torch.Tensor  # (n, 3) inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # (n,)
    colors: torch.Tensor  # (n, 3)
    depths: torch.Tensor  # (n,)
    rect: torch.Tensor  # (n, 4) tiles [x0, y0, x1, y1)
    visible: torch.Tensor  # (n,) bool


def quat_rotmat(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sh_color(shs: torch.Tensor, dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH of ``degree`` <= 3 (coefficients (n, K, 3)) along unit ``dirs``."""
    x, y, z = (dirs[:, i:i + 1] for i in range(3))
    c = SH_C0 * shs[:, 0]
    if degree > 0:
        c = c - SH_C1 * y * shs[:, 1] + SH_C1 * z * shs[:, 2] - SH_C1 * x * shs[:, 3]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * shs[:, 4] + SH_C2[1] * yz * shs[:, 5]
             + SH_C2[2] * (2 * zz - xx - yy) * shs[:, 6] + SH_C2[3] * xz * shs[:, 7]
             + SH_C2[4] * (xx - yy) * shs[:, 8])
        if degree > 2:
            c = (c + SH_C3[0] * y * (3 * xx - yy) * shs[:, 9] + SH_C3[1] * xy * z * shs[:, 10]
                 + SH_C3[2] * y * (4 * zz - xx - yy) * shs[:, 11]
                 + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * shs[:, 12]
                 + SH_C3[4] * x * (4 * zz - xx - yy) * shs[:, 13]
                 + SH_C3[5] * z * (xx - yy) * shs[:, 14]
                 + SH_C3[6] * x * (xx - 3 * yy) * shs[:, 15])
    return torch.clamp(c + 0.5, min=0.0)


def screen_space(a: Attributes, view: dict, sh_degree: int, prec: Precision) -> Screen:
    """EWA projection of the gaussians in ``view`` (tensors world_view,
    full_proj, center; numbers width, height, tan_fovx, tan_fovy)."""
    V, P = view["world_view"], view["full_proj"]
    W, H = view["width"], view["height"]
    tanx, tany = view["tan_fovx"], view["tan_fovy"]
    fx, fy = W / (2.0 * tanx), H / (2.0 * tany)
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    m = a.means
    t = m @ V[:3, :3] + V[3, :3]
    tz = t[:, 2]
    hom = m @ P[:3, :] + P[3, :]
    ndc = hom[:, :2] / (hom[:, 3:4] + W_EPS)
    pix = ((ndc + 1.0) * torch.tensor([W, H], dtype=m.dtype, device=m.device) - 1.0) * 0.5

    Rm = quat_rotmat(a.rotations)
    M = Rm * a.scales[:, None, :]
    sigma = M @ M.transpose(1, 2)
    txc = torch.clamp(t[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    tyc = torch.clamp(t[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, zero, -fx * txc / (tz * tz)], -1),
                     torch.stack([zero, fy / tz, -fy * tyc / (tz * tz)], -1)], -2)
    T = J @ V[:3, :3].T  # rows of the view rotation act on column vectors
    cov = T @ sigma @ T.transpose(1, 2)
    c00, c01, c11 = cov[:, 0, 0] + LOWPASS, cov[:, 0, 1], cov[:, 1, 1] + LOWPASS
    det = c00 * c11 - c01 * c01
    det_ok = det != 0.0
    inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([c11 * inv, -c01 * inv, c00 * inv], -1)

    with torch.no_grad():
        mid = 0.5 * (c00 + c11)
        root = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        lam = torch.maximum(mid + root, mid - root)
        nsig = torch.clamp(torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * a.opacity) + 0.02,
                                                  min=0.0)), max=3.0)
        r = torch.ceil(nsig * torch.sqrt(lam))
        r3 = torch.ceil(3.0 * torch.sqrt(lam))
        px, py = pix[:, 0], pix[:, 1]
        x0 = torch.clamp(torch.floor((px - r) / TILE), 0, gx)
        y0 = torch.clamp(torch.floor((py - r) / TILE), 0, gy)
        x1 = torch.clamp(torch.minimum(torch.floor((px + r) / TILE) + 1,
                                       torch.floor((px + r3 + TILE - 1) / TILE)), 0, gx)
        y1 = torch.clamp(torch.minimum(torch.floor((py + r) / TILE) + 1,
                                       torch.floor((py + r3 + TILE - 1) / TILE)), 0, gy)
        rect = torch.stack([x0, y0, x1, y1], -1).long()
        visible = (tz > NEAR_Z) & det_ok & ((x1 - x0) * (y1 - y0) > 0)

    dirs = m - view["center"]
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), min=1e-12)
    colors = sh_color(a.shs, dirs, sh_degree)
    return Screen(rnd(pix, prec.rest), rnd(conics, prec.rest), a.opacity,
                  rnd(colors, prec.rest), tz.detach(), rect, visible)


# --- binning and blending ------------------------------------------------

class Plan(NamedTuple):
    gid: torch.Tensor  # (I,) gaussian of each instance, in (tile, depth, index) order
    tile_start: torch.Tensor  # (T + 1,) first instance of each tile
    box: torch.Tensor  # (I, 4) first pixel x, y and pixels wide, high of each instance's pairs
    grid_x: int
    grid_y: int
    width: int
    height: int
    blocks: List[tuple]  # (t0, t1) tile ranges of at most MAX_PAIRS pairs (or one tile)


def plan(s: Screen, width: int, height: int, max_pairs: int = MAX_PAIRS) -> Plan:
    """Instances in (tile, depth, index) order, and for each the pixels of
    its tile, inside the image, where its gaussian can reach alpha >= 1/255:
    the box around the ellipse q <= 2 ln(opacity / (1/255)), widened by a
    pixel (a whole tile where the conic is not positive definite)."""
    gx, gy = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    dev = s.depths.device
    idx = torch.nonzero(s.visible)[:, 0]
    g = idx[torch.sort(s.depths[idx], stable=True).indices]
    x0, y0, x1, y1 = s.rect[g].unbind(-1)
    w = x1 - x0
    reps = w * (y1 - y0)
    inst = torch.repeat_interleave(g, reps)
    k = torch.arange(inst.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(reps, 0) - reps, reps)
    wi = torch.repeat_interleave(w, reps)
    tile = (torch.repeat_interleave(y0, reps) + k // wi) * gx + torch.repeat_interleave(
        x0, reps) + k % wi
    order = torch.sort(tile, stable=True).indices
    gid, tile = inst[order], tile[order]
    counts = torch.bincount(tile, minlength=gx * gy)
    start = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])

    with torch.no_grad():
        a, b, c = s.conics[gid].unbind(-1)
        mx, my = s.means2d[gid].unbind(-1)
        det = a * c - b * b
        thr = 2.0 * torch.log(torch.clamp(s.opacity[gid] / ALPHA_MIN, min=1.0))
        ok = (a > 0) & (c > 0) & (det > 0) & torch.isfinite(mx + my + a + b + c + thr)
        safe = torch.where(ok, det, 1.0)
        ex = torch.where(ok, torch.sqrt(thr * c / safe) * 1.001 + 1.0, float(TILE))
        ey = torch.where(ok, torch.sqrt(thr * a / safe) * 1.001 + 1.0, float(TILE))
        tx0, ty0 = (tile % gx) * TILE, (tile // gx) * TILE
        full = ~ok
        mx, my = torch.where(ok, mx, 0.0), torch.where(ok, my, 0.0)
        xl = torch.where(full, tx0, torch.maximum(torch.ceil(mx - ex).long(), tx0))
        yl = torch.where(full, ty0, torch.maximum(torch.ceil(my - ey).long(), ty0))
        xh = torch.where(full, tx0 + TILE - 1, torch.floor(mx + ex).long())
        yh = torch.where(full, ty0 + TILE - 1, torch.floor(my + ey).long())
        xh = torch.minimum(torch.minimum(xh, tx0 + TILE - 1), torch.full_like(xh, width - 1))
        yh = torch.minimum(torch.minimum(yh, ty0 + TILE - 1), torch.full_like(yh, height - 1))
        bw = torch.clamp(xh - xl + 1, min=0)
        bh = torch.clamp(yh - yl + 1, min=0)
        box = torch.stack([xl, yl, bw, bh], -1)
        per_tile = torch.zeros(gx * gy, dtype=torch.int64, device=dev).index_add(
            0, tile, bw * bh)
    blocks, t0, acc = [], 0, 0
    for t, n in enumerate(per_tile.tolist()):
        if acc and acc + n > max_pairs:
            blocks.append((t0, t))
            t0, acc = t, 0
        acc += n
    blocks.append((t0, gx * gy))
    return Plan(gid, start, box, gx, gy, width, height, blocks)


def _alpha(m2, con, op, g, px, py):
    dx = m2[g, 0] - px
    dy = m2[g, 1] - py
    power = -0.5 * (con[g, 0] * dx * dx + con[g, 2] * dy * dy) - con[g, 1] * dx * dy
    return power, torch.clamp(op[g] * torch.exp(power), max=ALPHA_MAX)


def _block(p: Plan, t0: int, t1: int, m2, con, op, col, work: Optional[dict] = None):
    """Colour (nb * 256, 3) and final transmittance (nb * 256,) of the pixels
    of tiles [t0, t1), pixel-major within each tile."""
    dev = m2.device
    ts = p.tile_start
    counts = ts[t0 + 1:t1 + 1] - ts[t0:t1]
    nb = t1 - t0
    lo = int(ts[t0])
    box = p.box[lo:int(ts[t1])]
    n_pairs = box[:, 2] * box[:, 3]
    ip = torch.repeat_interleave(torch.arange(box.shape[0], device=dev), n_pairs)
    k = torch.arange(ip.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(n_pairs, 0) - n_pairs, n_pairs)
    bw = box[ip, 2]
    ix = box[ip, 0] + k % bw
    iy = box[ip, 1] + k // bw
    tile = iy // TILE * p.grid_x + ix // TILE
    seg = (tile - t0) * NPIX + (iy % TILE) * TILE + ix % TILE
    order = torch.sort(seg, stable=True).indices  # (pixel, depth order) within each tile
    seg, li = seg[order], ip[order]
    px, py = ix[order].to(m2.dtype), iy[order].to(m2.dtype)
    g = p.gid[lo + li]
    with torch.no_grad():
        power, alpha = _alpha(m2, con, op, g, px, py)
        sel = torch.nonzero((power <= 0.0) & (alpha >= ALPHA_MIN))[:, 0]
    del power, alpha
    seg, g, px, py, li = seg[sel], g[sel], px[sel], py[sel], li[sel]
    _, alpha = _alpha(m2, con, op, g, px, py)
    ld = torch.log1p(-alpha).double()
    cs = torch.cumsum(ld, 0)
    first = torch.ones_like(seg, dtype=torch.bool)
    first[1:] = seg[1:] != seg[:-1]
    fi = torch.nonzero(first)[:, 0]
    seg_off = torch.zeros(nb * NPIX, dtype=torch.float64, device=dev).index_put(
        (seg[fi],), (cs - ld)[fi])
    excl = cs - ld - seg_off[seg]
    with torch.no_grad():
        contrib = torch.exp(excl + ld).float() >= T_EPS
    w = alpha * torch.exp(excl).float() * contrib
    rgb = torch.zeros((nb * NPIX, 3), dtype=m2.dtype, device=dev).index_add(
        0, seg, col[g] * w[:, None])
    log_t = torch.zeros(nb * NPIX, dtype=torch.float64, device=dev).index_add(
        0, seg, ld * contrib)
    if work is not None:
        with torch.no_grad():
            _count(work, p, t0, t1, counts, seg, li, g, contrib, dev)
    return rgb, torch.exp(log_t).to(m2.dtype)


def _count(work, p, t0, t1, counts, seg, li, g, contrib, dev):
    """Pair counts of one block (see ``render``)."""
    nb = t1 - t0
    n_inst = int(counts.sum())
    needed = torch.zeros(n_inst, dtype=torch.int64, device=dev).index_fill(0, li, 1)
    cum = torch.cat([needed.new_zeros(1), torch.cumsum(needed, 0)])
    tbase = p.tile_start[t0:t1] - p.tile_start[t0]
    in_tile = cum[tbase + counts] - cum[tbase]
    tile_of_seg = torch.arange(nb * NPIX, device=dev) // NPIX
    pix = torch.arange(NPIX, device=dev).repeat(nb)
    tx = (t0 + tile_of_seg) % p.grid_x * TILE + pix % TILE
    ty = (t0 + tile_of_seg) // p.grid_x * TILE + pix // TILE
    inimg = (tx < p.width) & (ty < p.height)
    big = torch.iinfo(torch.int64).max
    stop = torch.full((nb * NPIX,), big, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg[~contrib], li[~contrib], "amin")
    last = torch.full((nb * NPIX,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg[contrib], li[contrib], "amax")
    base = cum[tbase[tile_of_seg]]
    fwd = torch.where(stop < big, cum[torch.clamp(stop, max=n_inst - 1) + 1] - base,
                      in_tile[tile_of_seg])
    bwd = torch.where(last >= 0, cum[torch.clamp(last, min=0) + 1] - base, 0)
    work["needed_pairs"] += int(needed.sum())
    work["walked"] += int(fwd[inimg].sum())
    work["walked_bwd"] += int(bwd[inimg].sum())
    work["contributing"] += int(contrib.sum())
    work["touched"][g] = True


class Composite(torch.autograd.Function):
    """Blend of all blocks; the backward recomputes each block."""

    @staticmethod
    def forward(ctx, m2, con, op, col, p: Plan, work: Optional[dict]):
        T = len(p.tile_start) - 1
        rgb = torch.zeros((T * NPIX, 3), dtype=m2.dtype, device=m2.device)
        final = torch.ones(T * NPIX, dtype=m2.dtype, device=m2.device)
        with torch.no_grad():
            for t0, t1 in p.blocks:
                rgb[t0 * NPIX:t1 * NPIX], final[t0 * NPIX:t1 * NPIX] = _block(
                    p, t0, t1, m2, con, op, col, work)
        ctx.save_for_backward(m2, con, op, col)
        ctx.plan = p
        return rgb, final

    @staticmethod
    def backward(ctx, g_rgb, g_final):
        p = ctx.plan
        leaves = [x.detach().requires_grad_(True) for x in ctx.saved_tensors]
        grads = [torch.zeros_like(x) for x in leaves]
        for t0, t1 in p.blocks:
            with torch.enable_grad():
                rgb, final = _block(p, t0, t1, *leaves)
            sl = slice(t0 * NPIX, t1 * NPIX)
            got = torch.autograd.grad((rgb, final), leaves, (g_rgb[sl], g_final[sl]),
                                      allow_unused=True)
            for acc, gr in zip(grads, got):
                if gr is not None:
                    acc += gr
        return (*grads, None, None)


def new_work(n: int, device) -> dict:
    return {"needed_pairs": 0, "walked": 0, "walked_bwd": 0, "contributing": 0,
            "touched": torch.zeros(n, dtype=torch.bool, device=device)}


def image(s: Screen, view: dict, bg: torch.Tensor, prec: Precision,
          work: Optional[dict] = None):
    """(3, H, W) image over ``bg``.  With ``work`` (``new_work``) also adds
    the frame's counts: ``needed_pairs``, (gaussian, tile) pairs whose
    gaussian reaches alpha >= 1/255 at a pixel of the tile; ``walked``, the
    (pixel, needed pair) pairs up to and including the one that stops the
    pixel; ``walked_bwd``, those up to the pixel's last contributing pair;
    ``contributing``; ``touched``, the gaussians with a needed pair."""
    W, H = view["width"], view["height"]
    p = plan(s, W, H)
    rgb, final = Composite.apply(s.means2d, s.conics, s.opacity, s.colors, p, work)
    gy = p.grid_y

    def frame(x, c):
        x = x.reshape(gy, p.grid_x, TILE, TILE, c).permute(4, 0, 2, 1, 3)
        return x.reshape(c, gy * TILE, p.grid_x * TILE)[:, :H, :W]

    img = frame(rgb, 3) + frame(final[:, None], 1) * bg[:, None, None]
    return rnd(img, prec.rest)


def view_tensors(view, device) -> dict:
    """A ``scene.View`` as the tensors and numbers ``screen_space`` takes."""
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return {"world_view": f32(view.world_view), "full_proj": f32(view.full_proj),
            "center": f32(view.center), "time": view.time, "width": view.width,
            "height": view.height, "tan_fovx": view.tan_fovx, "tan_fovy": view.tan_fovy}


def render(config: dict, nets: dict, g: Dict[str, torch.Tensor], view: dict,
           bg: torch.Tensor, prec: Precision, work: Optional[dict] = None):
    """(image (3, H, W), dx (n, 3)) of the gaussians ``g`` in ``view``."""
    a = deformed(config, nets, g, view["time"], prec)
    s = screen_space(a, view, config["sh_degree"], prec)
    return image(s, view, bg, prec, work), a.dx
