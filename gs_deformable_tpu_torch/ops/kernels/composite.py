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
_SIGNATURES = {
    "composite_forward": (_P, ctypes.c_longlong, _P, _P, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_float,
                          ctypes.c_float, _P, _P),
}
_BWD_SIGNATURES = {
    "composite_backward": (_P, ctypes.c_longlong, _P, _P, ctypes.c_int, _P, _P,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                           _P, _P),
}


class Work(NamedTuple):
    """(instance, pixel) pairs a sequential composite evaluates."""

    evaluated: int  # pairs tested before each pixel stopped
    contributing: int  # pairs that blended into a pixel


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
):
    """Vectorized over tiles x pixels, a Python loop over the in-tile rank.

    Same float operations in the same order as the kernel.  With
    ``count_work`` also returns the ``Work`` this input needs.
    """
    Kp = splats_t.shape[1]
    T = tile_count.shape[0]
    dev = splats_t.device
    px, py = _pixel_coords(T, grid_x, dev)
    start = tile_chunk_start.long() * chunk
    count = tile_count.long()
    trans = torch.ones((T, NPIX), dtype=torch.float32, device=dev)
    rgb = torch.zeros((3, T, NPIX), dtype=torch.float32, device=dev)
    ncon = torch.zeros((T, NPIX), dtype=torch.int32, device=dev)
    done = torch.zeros((T, NPIX), dtype=torch.bool, device=dev)
    evaluated = torch.zeros((), dtype=torch.int64, device=dev)
    contributing = torch.zeros((), dtype=torch.int64, device=dev)
    amax = torch.tensor(alpha_max, dtype=torch.float32, device=dev)
    max_count = int(count.max()) if T > 0 else 0
    for i in range(max_count):
        valid = (i < count)[:, None]  # (T, 1)
        s = splats_t[:9, torch.clamp(start + i, max=Kp - 1)]  # (9, T)
        xg, yg, ca, cb, cc, op = (s[f][:, None] for f in range(6))
        dx = xg - px
        dy = yg - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.minimum(amax, op * torch.exp(power))
        live = valid & ~done
        skip = (power > 0.0) | (alpha < alpha_min) | ~live
        test_t = trans * (1.0 - alpha)
        stop = ~skip & (test_t < eps)
        contrib = ~skip & ~stop
        if count_work:
            evaluated += live.sum()
            contributing += contrib.sum()
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
        return out, Work(int(evaluated), int(contributing))
    return out


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
) -> torch.Tensor:
    """Vectorized over tiles x pixels, a Python loop over the in-tile rank.

    Recomputes the forward's walk with its float operations, termination
    at ``eps`` included (the kernel bounds its walk by ``fwd_out``'s
    n_contrib instead; the two agree when ``fwd_out`` is this input's
    forward).  The nine sums run over the pixel axis.
    """
    Kp = splats_t.shape[1]
    T = tile_count.shape[0]
    dev = splats_t.device
    px, py = _pixel_coords(T, grid_x, dev)
    start = tile_chunk_start.long() * chunk
    count = tile_count.long()
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
        alpha = torch.minimum(amax, op * g)
        skip = (power > 0.0) | (alpha < alpha_min) | ~in_tile[:, None] | done
        test_t = trans * (1.0 - alpha)
        stop = ~skip & (test_t < eps)
        contrib = ~skip & ~stop
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
        splats_t.data_ptr(), splats_t.shape[1], starts.data_ptr(), counts.data_ptr(), T,
        fwd_out.data_ptr(), grad_out.data_ptr(), grid_x, chunk, alpha_max, alpha_min,
        dsplats.data_ptr(), stream)
    _build.check(err, "composite_backward")
    composite_backward.launches += 1
    return dsplats


composite_backward.launches = 0


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
