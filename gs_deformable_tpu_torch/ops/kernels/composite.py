"""Tile composite, forward and backward, and its autograd ``Composite``.

- ``composite_forward(splats_t, tile_chunk_start, tile_count, ...)`` takes
  the field-major ``(16, Kp)`` sorted splats ``[x, y, conic_a, conic_b,
  conic_c, opacity, r, g, b, 0...]`` and returns ``(T, 8, 256)`` rows
  ``[r, g, b, final_T, n_contrib, 0, 0, 0]`` per 16x16 tile (CUDA source
  ``csrc/composite_fwd.cu``; replaces ``ops/pallas/composite.py:
  _forward_kernel``, ``stream_composite.py:_stream_forward_kernel`` and
  ``packed_composite.py:_packed_forward_kernel``).
- ``composite_backward(..., fwd_out, grad_out)`` returns the ``(16, Kp)``
  per-instance gradient rows ``[dx, dy, dconic_a, dconic_b, dconic_c,
  dopacity, dr, dg, db, 0...]`` (CUDA source ``csrc/composite_bwd.cu``;
  replaces ``stream_composite.py:_stream_backward_kernel``,
  ``composite.py:_backward_kernel`` and
  ``packed_composite.py:_packed_backward_kernel``).

``chunk`` only sets the layout: tile t's instances start at row
``tile_chunk_start[t] * chunk``.  The packed schedule calls the same two
kernels and plain versions with ``chunk = sub_chunk``, so its tiles may
open in the middle of a 128-row chunk; nothing here depends on alignment.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ... import _build

SPLAT_WIDTH = 16
TILE = 16
NPIX = TILE * TILE
OUT_ROWS = 8

_P = ctypes.c_void_p
_OCC = (ctypes.POINTER(ctypes.c_int),)
_SIGNATURES = {
    "composite_forward": (_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float, _P, _P),
    "composite_forward_occupancy": _OCC,
}
_BWD_SIGNATURES = {
    "composite_backward": (_P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P, _P,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                           _P, _P),
    "composite_backward_occupancy": _OCC,
}

WARPS = NPIX // 32
WARP_ROWS, WARP_COLS = 4, 8  # each warp of a tile's block holds a 4 x 8 pixel block
CULL_SLACK = 0.02  # csrc/composite_common.cuh
CULL_REL = 1e-5


def _warp_of_pixel():
    """(NPIX,) the warp holding each pixel of a tile (row-major pixel index)."""
    pix = torch.arange(NPIX)
    row, col = pix // TILE, pix % TILE
    return (row // WARP_ROWS) * (TILE // WARP_COLS) + col // WARP_COLS


WARP_OF_PIXEL = _warp_of_pixel()


class Work(NamedTuple):
    """(instance, pixel) and (instance, warp) pairs a sequential composite meets.

    The forward counts pairs tested before each pixel stopped; the backward
    (whose kernel walks each pixel up to its n_contrib and each warp up to
    its largest) counts pairs before n_contrib.  A warp pair is one instance
    against one warp's 4 x 8 pixels.
    """

    evaluated: int  # (instance, pixel) pairs walked
    contributing: int  # pairs that blended into a pixel
    evaluated_kept: int = 0  # walked pairs whose warp the warp cull keeps
    warps_walked: int = 0  # (instance, warp) pairs the warp reaches
    warps_kept: int = 0  # of those, kept by the warp cull
    warps_contributing: int = 0  # of those, holding a contributing lane


def warp_mask(s: torch.Tensor, px0: torch.Tensor, py0: torch.Tensor,
              alpha_min: float) -> torch.Tensor:
    """The warp cull of ``csrc/composite_common.cuh:warp_keeps``, all 8 warps.

    ``s`` holds at least the fields [x, y, conic_a, conic_b, conic_c,
    opacity] of N instances as rows, ``px0``/``py0`` (N,) the first pixel of
    each one's tile.  Returns (N,) int32 masks: bit w is set when the
    instance may contribute to a pixel of warp w, whose 4 x 8 pixel block
    starts at row 4 (w // 2), column 8 (w % 2) of the tile: when the least
    q = a dx^2 + 2b dx dy + c dy^2 over that block is within
    2 ln(op / alpha_min) plus ``CULL_SLACK`` plus ``CULL_REL`` of the q
    terms' magnitude.  Conservative: a non-finite field or a conic that is
    not positive definite sets every bit; the one exact exclusion,
    0 < alpha_min and op < alpha_min, sets none.
    """
    x, y, a, b, c, op = s[:6]
    finite = torch.isfinite(x + y + a + b + c + op)
    definite = (a > 0.0) & (c > 0.0) & (a * c - b * b > 0.0)
    thr = 2.0 * torch.log(op / alpha_min) + CULL_SLACK
    kx, ky = -b / c, -b / a

    def quad(dx, dy):
        return a * dx * dx + 2.0 * b * dx * dy + c * dy * dy

    mask = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for w in range(WARPS):
        rx0 = px0 + float((w % 2) * WARP_COLS)
        ry0 = py0 + float((w // 2) * WARP_ROWS)
        ax, bx = x - (rx0 + float(WARP_COLS - 1)), x - rx0
        ay, by = y - (ry0 + float(WARP_ROWS - 1)), y - ry0
        inside = (ax <= 0.0) & (bx >= 0.0) & (ay <= 0.0) & (by >= 0.0)
        edges = torch.stack([quad(ax, torch.clamp(kx * ax, ay, by)),
                             quad(bx, torch.clamp(kx * bx, ay, by)),
                             quad(torch.clamp(ky * ay, ax, bx), ay),
                             quad(torch.clamp(ky * by, ax, bx), by)])
        qmin = torch.where(inside, 0.0, edges.amin(0))
        margin = CULL_REL * ((a + b.abs()) * torch.maximum(ax * ax, bx * bx)
                             + (c + b.abs()) * torch.maximum(ay * ay, by * by))
        mask = mask | ((~(qmin > thr + margin)).to(torch.int32) << w)
    mask = torch.where(definite, mask, 0xFF)
    if alpha_min > 0.0:
        mask = torch.where(op < alpha_min, 0, mask)
    return torch.where(finite, mask, 0xFF).to(torch.int32)


def _tile_origins(num_tiles: int, grid_x: int, device):
    t = torch.arange(num_tiles, device=device)
    return (((t % grid_x) * TILE).to(torch.float32),
            ((t // grid_x) * TILE).to(torch.float32))


def _warp_keep(s, origins, alpha_min):
    """(T, WARPS) bool: the cull's bits for each tile's instance ``s`` (9, T)."""
    mask = warp_mask(s, *origins, alpha_min)
    shifts = torch.arange(WARPS, device=mask.device, dtype=torch.int32)
    return ((mask[:, None] >> shifts) & 1).bool()


def _per_pixel(warp_bits):
    """(T, WARPS) -> (T, NPIX): each pixel takes its warp's value."""
    return warp_bits[:, WARP_OF_PIXEL.to(warp_bits.device)]


def _by_warp(per_pixel):
    """(T, NPIX) -> (T, WARPS, 32): each warp's 32 pixels."""
    T = per_pixel.shape[0]
    blocks = per_pixel.view(T, TILE // WARP_ROWS, WARP_ROWS, TILE // WARP_COLS, WARP_COLS)
    return blocks.permute(0, 1, 3, 2, 4).reshape(T, WARPS, 32)


def _pixel_coords(num_tiles: int, grid_x: int, device):
    t = torch.arange(num_tiles, device=device)[:, None]
    p = torch.arange(NPIX, device=device)[None, :]
    px = ((t % grid_x) * TILE + p % TILE).to(torch.float32)
    py = ((t // grid_x) * TILE + p // TILE).to(torch.float32)
    return px, py


def composite_forward_plain(
    splats_t: torch.Tensor,
    tile_chunk_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    grid_x: int,
    chunk: int,
    alpha_max: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    eps: float = 1e-4,
    count_work: bool = False,
    warp_cull: bool = False,
):
    """Vectorized over tiles x pixels, a Python loop over the in-tile rank.

    Same float operations in the same order as the kernel.  With
    ``count_work`` also returns the ``Work`` this input needs; with
    ``warp_cull`` a pair whose warp the cull drops is skipped, as in the
    kernel (the output does not change: the cull is conservative).
    """
    Kp = splats_t.shape[1]
    T = tile_count.shape[0]
    dev = splats_t.device
    px, py = _pixel_coords(T, grid_x, dev)
    origins = _tile_origins(T, grid_x, dev)
    start = tile_chunk_start.long() * chunk
    count = tile_count.long()
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    rgb = torch.zeros((3, T, NPIX), dtype=torch.float32, device=dev)
    ncon = torch.zeros((T, NPIX), dtype=torch.int32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    work = torch.zeros(len(Work._fields), dtype=torch.int64, device=dev)
    amax = torch.tensor(alpha_max, dtype=torch.float32, device=dev)
    max_count = int(count.max()) if T > 0 else 0
    for i in range(max_count):
        valid = (i < count)[:, None]  # (T, 1)
        s = splats_t[:9, torch.clamp(start + i, max=Kp - 1)]  # (9, T)
        xg, yg, ca, cb, cc, op = (s[f][:, None] for f in range(6))
        dx = xg - px
        dy = yg - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.fmin(amax, op * torch.exp(power))  # drops a NaN, as CUDA's fminf
        live = valid & ~done
        skip = (power > 0.0) | (alpha < alpha_min) | ~live
        if warp_cull or count_work:
            keep_w = _warp_keep(s, origins, alpha_min)  # (T, WARPS)
            keep = _per_pixel(keep_w)
        if warp_cull:
            skip = skip | ~keep
        test_t = trans * (1.0 - alpha)
        stop = ~skip & (test_t < eps)
        contrib = ~skip & ~stop
        if count_work:
            work += _count(live, contrib, keep, keep_w, _by_warp(live).any(-1))
        done = done | stop
        w = alpha * trans
        for ch in range(3):
            rgb[ch] = torch.where(contrib, rgb[ch] + s[6 + ch][:, None] * w, rgb[ch])
        trans = torch.where(contrib, test_t, trans)
        ncon = torch.where(contrib, i + 1, ncon)
    out = torch.zeros((T, OUT_ROWS, NPIX), dtype=torch.float32, device=dev)
    out[:, 0:3] = rgb.permute(1, 0, 2)
    out[:, 3] = trans
    out[:, 4] = ncon.to(torch.float32)
    if count_work:
        return out, Work(*(int(v) for v in work))
    return out


def _count(walked, contrib, keep, keep_w, warp_walked):
    """One rank's contribution to each ``Work`` field, as a tensor."""
    return torch.stack([walked.sum(), contrib.sum(), (walked & keep).sum(), warp_walked.sum(),
                        (warp_walked & keep_w).sum(),
                        _by_warp(contrib).any(-1).sum()])


def _check_inputs(splats_t, tile_chunk_start, tile_count, tile_rows=()):
    """Raise on what the kernels do not take; True when the inputs lie on the CPU."""
    if splats_t.dtype != torch.float32 or splats_t.dim() != 2 or splats_t.shape[0] != SPLAT_WIDTH:
        raise ValueError("splats_t must be (16, Kp) float32, got "
                         f"{splats_t.dtype} {tuple(splats_t.shape)}")
    for name, t in (("tile_chunk_start", tile_chunk_start), ("tile_count", tile_count)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} {tuple(t.shape)}")
    if tile_chunk_start.shape != tile_count.shape or tile_count.shape[0] < 1:
        raise ValueError("tile tables must share one non-empty (T,) shape")
    want = (tile_count.shape[0], OUT_ROWS, NPIX)
    for name, t in tile_rows:
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} float32, got {t.dtype} {tuple(t.shape)}")
    tensors = (splats_t, tile_chunk_start, tile_count, *(t for _, t in tile_rows))
    if splats_t.device.type == "cpu":
        return True
    if splats_t.device.type != "cuda" or {t.device for t in tensors} != {splats_t.device}:
        raise ValueError("composite inputs must share one CUDA device")
    return False


def composite_forward(
    splats_t: torch.Tensor,
    tile_chunk_start: torch.Tensor,
    tile_count: torch.Tensor,
    *,
    grid_x: int,
    chunk: int,
    alpha_max: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    eps: float = 1e-4,
) -> torch.Tensor:
    """(16, Kp) fp32 splats, (T,) int32 tables -> (T, 8, 256) fp32.

    Launches ``csrc/composite_fwd.cu``, the port of ``composite.py:
    _forward_kernel``, ``stream_composite.py:_stream_forward_kernel`` and,
    with ``chunk = sub_chunk``, ``packed_composite.py:_packed_forward_kernel``.
    """
    kw = dict(grid_x=grid_x, chunk=chunk, alpha_max=alpha_max, alpha_min=alpha_min, eps=eps)
    if _check_inputs(splats_t, tile_chunk_start, tile_count):
        return composite_forward_plain(splats_t, tile_chunk_start, tile_count, **kw)
    lib = _build.load("composite_fwd", _SIGNATURES)
    splats_t = splats_t.contiguous()
    starts = tile_chunk_start.contiguous()
    counts = tile_count.contiguous()
    T = counts.shape[0]
    out = torch.empty((T, OUT_ROWS, NPIX), dtype=torch.float32, device=splats_t.device)
    stream = torch.cuda.current_stream(splats_t.device).cuda_stream
    err = lib.composite_forward(
        splats_t.data_ptr(), splats_t.shape[1], starts.data_ptr(), counts.data_ptr(),
        T, grid_x, chunk, alpha_max, alpha_min, eps, out.data_ptr(), stream)
    _build.check(err, "composite_forward")
    composite_forward.launches += 1
    return out


composite_forward.launches = 0


def composite_backward_plain(
    splats_t: torch.Tensor,
    tile_chunk_start: torch.Tensor,
    tile_count: torch.Tensor,
    fwd_out: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    grid_x: int,
    chunk: int,
    alpha_max: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    eps: float = 1e-4,
    count_work: bool = False,
    warp_cull: bool = False,
):
    """Vectorized over tiles x pixels, a Python loop over the in-tile rank.

    Recomputes the forward's walk with its float operations, termination
    at ``eps`` included (the kernel bounds its walk by ``fwd_out``'s
    n_contrib instead; the two agree when ``fwd_out`` is this input's
    forward).  The nine sums run over the pixel axis.  With ``count_work``
    also returns the ``Work`` of the kernel's walk (each pixel up to its
    n_contrib in ``fwd_out``, each warp up to its largest); ``warp_cull``
    as in ``composite_forward_plain``.
    """
    Kp = splats_t.shape[1]
    T = tile_count.shape[0]
    dev = splats_t.device
    px, py = _pixel_coords(T, grid_x, dev)
    origins = _tile_origins(T, grid_x, dev)
    start = tile_chunk_start.long() * chunk
    count = tile_count.long()
    ncon = fwd_out[:, 4].long()  # (T, NPIX)
    warp_ncon = _by_warp(ncon).amax(-1)  # (T, WARPS): each warp's walk
    work = torch.zeros(len(Work._fields), dtype=torch.int64, device=dev)
    g_r, g_g, g_b, g_t = (grad_out[:, r] for r in range(4))
    gtotal = g_r * fwd_out[:, 0] + g_g * fwd_out[:, 1] + g_b * fwd_out[:, 2] + g_t * fwd_out[:, 3]
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    pcc = torch.zeros((T, NPIX), dtype=torch.float32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    dsplats = torch.zeros((SPLAT_WIDTH, Kp), dtype=torch.float32, device=dev)
    amax = torch.tensor(alpha_max, dtype=torch.float32, device=dev)
    max_count = int(count.max()) if T > 0 else 0
    for i in range(max_count):
        in_tile = i < count  # (T,)
        s = splats_t[:9, torch.clamp(start + i, max=Kp - 1)]  # (9, T)
        xg, yg, ca, cb, cc, op, c0, c1, c2 = (s[f][:, None] for f in range(9))
        dx = xg - px
        dy = yg - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        g = torch.exp(power)
        alpha = torch.fmin(amax, op * g)
        skip = (power > 0.0) | (alpha < alpha_min) | ~in_tile[:, None] | done
        if warp_cull or count_work:
            keep_w = _warp_keep(s, origins, alpha_min)  # (T, WARPS)
            keep = _per_pixel(keep_w)
        if warp_cull:
            skip = skip | ~keep
        test_t = trans * (1.0 - alpha)
        stop = ~skip & (test_t < eps)
        contrib = ~skip & ~stop
        if count_work:
            work += _count(i < ncon, contrib, keep, keep_w, i < warp_ncon)
        done = done | stop
        w = alpha * trans
        gcol = g_r * c0 + g_g * c1 + g_b * c2
        pcc = torch.where(contrib, pcc + w * gcol, pcc)
        dalpha = gcol * trans - (gtotal - pcc) * (1.0 / (1.0 - alpha))
        gg = op * dalpha * g
        per_pixel = (gg * (-(ca * dx + cb * dy)), gg * (-(cc * dy + cb * dx)),
                     gg * (-0.5 * dx * dx), gg * (-dx * dy), gg * (-0.5 * dy * dy),
                     g * dalpha, w * g_r, w * g_g, w * g_b)
        rows = torch.stack([torch.where(contrib, v, 0.0).sum(dim=1) for v in per_pixel])
        dsplats[:9, (start + i)[in_tile]] = rows[:, in_tile]
        trans = torch.where(contrib, test_t, trans)
    if count_work:
        return dsplats, Work(*(int(v) for v in work))
    return dsplats


def composite_backward(
    splats_t: torch.Tensor,
    tile_chunk_start: torch.Tensor,
    tile_count: torch.Tensor,
    fwd_out: torch.Tensor,
    grad_out: torch.Tensor,
    *,
    grid_x: int,
    chunk: int,
    alpha_max: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    eps: float = 1e-4,
) -> torch.Tensor:
    """(16, Kp) splats, tables, the forward's (T, 8, 256) out and the upstream
    gradient (rows 0-3 read) -> (16, Kp) per-instance gradient rows.

    Rows outside every tile's ``[start, start + count)`` are exactly 0.
    Launches ``csrc/composite_bwd.cu``, the port of ``stream_composite.py:
    _stream_backward_kernel``, ``composite.py:_backward_kernel`` and, with
    ``chunk = sub_chunk``, ``packed_composite.py:_packed_backward_kernel``.
    """
    kw = dict(grid_x=grid_x, chunk=chunk, alpha_max=alpha_max, alpha_min=alpha_min)
    if _check_inputs(splats_t, tile_chunk_start, tile_count,
                     (("fwd_out", fwd_out), ("grad_out", grad_out))):
        return composite_backward_plain(splats_t, tile_chunk_start, tile_count, fwd_out,
                                        grad_out, eps=eps, **kw)
    lib = _build.load("composite_bwd", _BWD_SIGNATURES)
    splats_t = splats_t.contiguous()
    starts = tile_chunk_start.contiguous()
    counts = tile_count.contiguous()
    fwd_out = fwd_out.contiguous()
    grad_out = grad_out.contiguous()
    T = counts.shape[0]
    # Zeros, not empty: the kernel writes only each tile's rows, and the
    # layout's padding slots carry gaussian 0 into the segment sum.
    dsplats = torch.zeros_like(splats_t)
    stream = torch.cuda.current_stream(splats_t.device).cuda_stream
    err = lib.composite_backward(
        splats_t.data_ptr(), splats_t.shape[1], starts.data_ptr(), counts.data_ptr(),
        T, fwd_out.data_ptr(), grad_out.data_ptr(), grid_x, chunk, alpha_max, alpha_min,
        dsplats.data_ptr(), stream)
    _build.check(err, "composite_backward")
    composite_backward.launches += 1
    return dsplats


composite_backward.launches = 0


def occupancy() -> dict:
    """Blocks of each composite kernel one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; builds the kernels)."""
    res = {}
    for name, src, sigs in (("composite_forward", "composite_fwd", _SIGNATURES),
                            ("composite_backward", "composite_bwd", _BWD_SIGNATURES)):
        blocks = ctypes.c_int(0)
        fn = f"{name}_occupancy"
        _build.check(getattr(_build.load(src, sigs), fn)(ctypes.byref(blocks)), fn)
        res[name] = blocks.value
    return res


class Composite(torch.autograd.Function):
    """``composite_forward`` with ``composite_backward`` as its gradient.

    ``apply(splats_t, tile_chunk_start, tile_count, grid_x, chunk, alpha_max,
    alpha_min, eps)``; only ``splats_t`` gets a gradient.
    """

    @staticmethod
    def forward(ctx, splats_t, tile_chunk_start, tile_count, grid_x, chunk, alpha_max,
                alpha_min, eps):
        kw = dict(grid_x=grid_x, chunk=chunk, alpha_max=alpha_max, alpha_min=alpha_min,
                  eps=eps)
        out = composite_forward(splats_t, tile_chunk_start, tile_count, **kw)
        ctx.save_for_backward(splats_t, tile_chunk_start, tile_count, out)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, grad_out):
        splats_t, tile_chunk_start, tile_count, out = ctx.saved_tensors
        dsplats = composite_backward(splats_t, tile_chunk_start, tile_count, out,
                                     grad_out.contiguous(), **ctx.kw)
        return (dsplats,) + (None,) * 7
