"""The exact per-tile ellipse cull as one launch (CUDA source ``csrc/tile_cull.cu``).

``tile_cull`` returns what ``ops.projection.tile_ellipse_mask`` returns,
``(mask_code, new_tiles)``: for CPU tensors from the plain loop
``projection.tile_ellipse_mask_plain``, for CUDA tensors from one kernel
launch that equals that loop run on the same CUDA tensors bit for bit.  It
replaces no TPU kernel: XLA fuses the JAX package's loop into one pass.

While tracing is on (``tracing``), the counters ``cull.rows`` (rows with
``tiles_touched > 0`` on entry) and ``cull.masked_rows`` (rows the exact
cull applies to: bit 16 of ``mask_code``) take each call's rows; on the
card the launch counts them itself, into two words that it zeroes first.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build, tracing

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "tile_cull": (_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _LL, _I, _I, _I, ctypes.c_float,
                  _P, _P, _P, _P),
}


def _lib():
    return _build.load("tile_cull", _SIGNATURES)


def _rows(name: str, t: torch.Tensor, dtype, cols: int, n: int):
    """``t`` as (n, cols) rows with unit column stride (a copy only where the
    columns are strided) and its row stride; (n,) and (n, 1) for cols 1."""
    shapes = ((n,), (n, 1)) if cols == 1 else ((n, cols),)
    if t.dtype != dtype or tuple(t.shape) not in shapes:
        raise ValueError(f"{name} must be {dtype} shaped {' or '.join(map(str, shapes))}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.dim() == 2 and cols > 1 and t.stride(1) != 1:
        t = t.contiguous()
    return t, t.stride(0)


def tile_cull(means2d_pix, conics, opacities, rect, tiles_touched, *, tile_x: int,
              tile_y: int, max_bits: int = 16, slack: float = 0.02):
    """(mask_code, new_tiles), each (P,) int32: see ``csrc/tile_cull.cu``."""
    device = means2d_pix.device
    if device.type == "cpu":
        from ..projection import tile_ellipse_mask_plain

        mask_code, new_tiles = tile_ellipse_mask_plain(
            means2d_pix, conics, opacities, rect, tiles_touched, tile_x=tile_x, tile_y=tile_y,
            max_bits=max_bits, slack=slack)
        if tracing.enabled():
            tracing.count("cull.rows", (tiles_touched > 0).sum())
            tracing.count("cull.masked_rows", (mask_code != 0).sum())
        return mask_code, new_tiles
    n = means2d_pix.shape[0]
    args = [_rows("means2d_pix", means2d_pix, torch.float32, 2, n),
            _rows("conics", conics, torch.float32, 3, n),
            _rows("opacities", opacities, torch.float32, 1, n),
            _rows("rect", rect, torch.int32, 4, n),
            _rows("tiles_touched", tiles_touched, torch.int32, 1, n)]
    if device.type != "cuda" or any(t.device != device for t, _ in args):
        raise ValueError(f"inputs on {[str(t.device) for t, _ in args]}: all on one CUDA device")
    mask_code = torch.empty((n,), dtype=torch.int32, device=device)
    new_tiles = torch.empty((n,), dtype=torch.int32, device=device)
    counts = torch.empty((2,), dtype=torch.int64, device=device) if tracing.enabled() else None
    ptrs = [x for t, ld in args for x in (t.data_ptr(), ld)]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _lib().tile_cull(*ptrs, n, tile_x, tile_y, max_bits, slack, mask_code.data_ptr(),
                           new_tiles.data_ptr(), None if counts is None else counts.data_ptr(),
                           stream)
    _build.check(err, "tile_cull")
    tile_cull.launches += 1
    if counts is not None:
        tracing.count("cull.rows", counts[0])
        tracing.count("cull.masked_rows", counts[1])
    return mask_code, new_tiles


tile_cull.launches = 0
