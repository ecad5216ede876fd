"""The deformation trunk's epilogues in the bf16 tiers (CUDA source ``csrc/trunk.cu``).

``models.deform`` multiplies bf16 operands into an fp32 product; these
functions do the rest of a layer in one pass each, writing bf16 into
``out`` (which may be a column slice of a wider buffer):

- ``bias_relu_bf16(y, b, out)``: ``out = bf16(relu(y + b))``, the forward;
- ``relu_mask_bf16(g, a, out, rounded)``: ``v = where(a > 0, g, 0)``,
  ``out = bf16(v)``, the backward through the cast and the ReLU whose output
  ``a`` was stored; returns the column sums of ``out`` (``rounded``) or of
  ``v``, the bias's cotangent.

They replace no TPU kernel (XLA fuses the same elementwise work into its
dot).  The plain versions below run for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    "trunk_bias_relu": (_P, _LL, _P, _P, _LL, _LL, _I, _P),
    "trunk_relu_mask": (_P, _LL, _P, _LL, _P, _LL, _LL, _I, _I, _P, _P),
    "trunk_relu_mask_blocks": (_LL, _I),
}


def _lib():
    return _build.load("trunk", _SIGNATURES)


def bias_relu_plain(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.relu(y + b).to(torch.bfloat16)


def relu_mask_plain(g: torch.Tensor, a: torch.Tensor, rounded: bool):
    v = torch.where(a > 0, g, 0)
    out = v.to(torch.bfloat16)
    return out, (out.to(torch.float32) if rounded else v).sum(0)


def _check(name, src: torch.Tensor, src_dtype, out: torch.Tensor, extra=()) -> None:
    for what, t, dtype in ((name, src, src_dtype), ("out", out, torch.bfloat16), *extra):
        if t.dtype != dtype or t.dim() != 2 or t.shape != out.shape:
            raise ValueError(f"{what} must be {dtype} shaped {tuple(out.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != out.device:
            raise ValueError(f"{what} on {t.device}, out on {out.device}")
        if t.device.type == "cuda":
            words = 16 // t.element_size()
            if t.stride(1) != 1 or t.stride(0) % words or t.data_ptr() % 16:
                raise ValueError(f"{what}: rows must be contiguous and 16-byte aligned")
    if out.device.type == "cuda" and out.shape[1] % 8:
        raise ValueError(f"columns must be a multiple of 8, got {out.shape[1]}")


def bias_relu_bf16(y: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[:] = bf16(relu(y + b))`` for fp32 ``y`` (n, C) and ``b`` (C,)."""
    _check("y", y, torch.float32, out)
    if b.dtype != torch.float32 or b.shape != (out.shape[1],) or b.device != out.device:
        raise ValueError(f"b must be float32 ({out.shape[1]},) on {out.device}")
    if out.device.type == "cpu":
        return out.copy_(bias_relu_plain(y, b))
    b = b.contiguous()
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = _lib().trunk_bias_relu(y.data_ptr(), y.stride(0), b.data_ptr(), out.data_ptr(),
                                 out.stride(0), out.shape[0], out.shape[1], stream)
    _build.check(err, "trunk_bias_relu")
    bias_relu_bf16.launches += 1
    return out


def relu_mask_bf16(g: torch.Tensor, a: torch.Tensor, out: torch.Tensor,
                   rounded: bool) -> torch.Tensor:
    """``out[:] = bf16(where(a > 0, g, 0))`` for fp32 ``g`` and bf16 ``a``
    (n, C); returns the (C,) fp32 column sums of ``out`` (``rounded``) or of
    the fp32 ``where``."""
    _check("g", g, torch.float32, out, (("a", a, torch.bfloat16),))
    if out.device.type == "cpu":
        res, sums = relu_mask_plain(g, a, rounded)
        out.copy_(res)
        return sums
    lib = _lib()
    n, c = out.shape
    partial = torch.empty((lib.trunk_relu_mask_blocks(n, c), c), dtype=torch.float32,
                          device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = lib.trunk_relu_mask(g.data_ptr(), g.stride(0), a.data_ptr(), a.stride(0),
                              out.data_ptr(), out.stride(0), n, c, int(rounded),
                              partial.data_ptr(), stream)
    _build.check(err, "trunk_relu_mask")
    relu_mask_bf16.launches += 1
    return partial.sum(0)


bias_relu_bf16.launches = 0
relu_mask_bf16.launches = 0
