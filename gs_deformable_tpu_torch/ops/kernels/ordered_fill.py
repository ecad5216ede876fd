"""Ordered fill: prefix fill / placement of rows at sorted unique positions.

The port of ``gs_deformable_tpu/ops/pallas/ordered_fill.py`` (kernel
``_kernel``; CUDA source ``csrc/ordered_fill.cu``).  For int32 positions
``pos`` sorted ascending and unique (entries < 0 or >= K drop):

- ``ordered_prefix_fill(pos, delta, K)``: ``out[c, k] = sum over j with
  pos[j] <= k of delta[j, c]``, field-major ``(C, K)``, ``C <= 8``;
- ``ordered_place_i32(pos, vals, K)``: ``zeros(K).at[pos].set(vals)``.

Both carry int32 end to end, so they are exact: the JAX version's fp32
lanes hold the same integers (every value there is below 2^24).  Each call
on the card is one kernel launch, and each is a pure function of its
inputs, also when it is captured into a CUDA graph and replayed (see the
head note of the CUDA source): a call issued from the host takes the small
status buffer kept here per device and stream, with a new epoch; a call
under capture takes a buffer of its own, zeroed inside the capture, and
epoch 1.
"""

from __future__ import annotations

import ctypes

import torch

from ... import _build

MAX_C = 8
_P = ctypes.c_void_p
_SIGNATURES = {
    "ordered_prefix_fill": (_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                            ctypes.c_uint, _P, _P),
    "ordered_place_i32": (_P, _P, ctypes.c_int, ctypes.c_int, _P, _P),
    "ordered_fill_state_words": (ctypes.c_int,),
}
_LAST_EPOCH = 0xFFFFFFFF
_status: dict = {}  # (device index, stream) -> [int64 status buffer, epoch of its last launch]


def _lib():
    return _build.load("ordered_fill", _SIGNATURES)


def _status_for(lib, device: torch.device, stream: int, K: int):
    """The status buffer for a launch at K on ``stream`` and the launch's epoch.

    Under CUDA-graph capture: a fresh zeroed buffer and epoch 1.  The capture
    records the zeroing as a node ahead of the kernel, so every replay starts
    from words that carry no epoch, and no two captured calls share words.
    Otherwise the buffer of (device, stream) and its next epoch; after epoch
    2^32 - 1 the buffer is replaced by a zeroed one, so no word of an earlier
    launch can carry the epoch of a later one.
    """
    words = lib.ordered_fill_state_words(K)
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((words,), dtype=torch.int64, device=device), 1
    st = _status.get((device.index, stream))
    if st is None or st[0].numel() < words or st[1] == _LAST_EPOCH:
        st = [torch.zeros((words,), dtype=torch.int64, device=device), 0]
        _status[(device.index, stream)] = st
    st[1] += 1
    return st[0], st[1]


def _check_pos(pos: torch.Tensor) -> None:
    if pos.dtype != torch.int32 or pos.dim() != 1:
        raise ValueError(f"pos must be 1-D int32, got {pos.dtype} {tuple(pos.shape)}")


def prefix_fill_plain(pos: torch.Tensor, delta: torch.Tensor, K: int) -> torch.Tensor:
    """Scatter into zeros, then a cumsum over positions."""
    ok = (pos >= 0) & (pos < K)
    seg = torch.zeros((K, delta.shape[1]), dtype=torch.int32, device=delta.device)
    seg[pos[ok].long()] = delta[ok]
    return torch.cumsum(seg, dim=0).to(torch.int32).t().contiguous()


def place_plain(pos: torch.Tensor, vals: torch.Tensor, K: int) -> torch.Tensor:
    ok = (pos >= 0) & (pos < K)
    out = torch.zeros((K,), dtype=torch.int32, device=vals.device)
    out[pos[ok].long()] = vals[ok]
    return out


def ordered_prefix_fill(pos: torch.Tensor, delta: torch.Tensor, K: int) -> torch.Tensor:
    """pos (n,) int32 sorted unique; delta (n, C) int32 -> (C, K) int32."""
    _check_pos(pos)
    if delta.dtype != torch.int32 or delta.dim() != 2 or delta.shape[0] != pos.shape[0]:
        raise ValueError(f"delta must be (n, C) int32, got {delta.dtype} {tuple(delta.shape)}")
    n, C = delta.shape
    if not 1 <= C <= MAX_C or K < 1:
        raise ValueError(f"need 1 <= C <= {MAX_C} and K >= 1 (C={C}, K={K})")
    if pos.device.type == "cpu":
        return prefix_fill_plain(pos, delta, K)
    if pos.device.type != "cuda" or delta.device != pos.device:
        raise ValueError(f"pos/delta on {pos.device}/{delta.device}")
    lib = _lib()
    pos = pos.contiguous()
    delta = delta.contiguous()
    if delta.data_ptr() % 16:  # the kernel reads rows with vector loads
        delta = delta.clone()
    out = torch.empty((C, K), dtype=torch.int32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    state, epoch = _status_for(lib, pos.device, stream, K)
    err = lib.ordered_prefix_fill(pos.data_ptr(), delta.data_ptr(), n, C, K,
                                  state.data_ptr(), epoch, out.data_ptr(), stream)
    _build.check(err, "ordered_prefix_fill")
    ordered_prefix_fill.launches += 1
    return out


def ordered_place_i32(pos: torch.Tensor, vals: torch.Tensor, K: int) -> torch.Tensor:
    """``zeros(K, int32).at[pos].set(vals)`` for sorted unique int32 positions."""
    _check_pos(pos)
    if vals.dtype != torch.int32 or vals.shape != pos.shape:
        raise ValueError(f"vals must be int32 shaped like pos, got {vals.dtype} {tuple(vals.shape)}")
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    if pos.device.type == "cpu":
        return place_plain(pos, vals, K)
    if pos.device.type != "cuda" or vals.device != pos.device:
        raise ValueError(f"pos/vals on {pos.device}/{vals.device}")
    lib = _lib()
    pos = pos.contiguous()
    vals = vals.contiguous()
    out = torch.empty((K,), dtype=torch.int32, device=pos.device)
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = lib.ordered_place_i32(pos.data_ptr(), vals.data_ptr(), pos.shape[0], K,
                                out.data_ptr(), stream)
    _build.check(err, "ordered_place_i32")
    ordered_place_i32.launches += 1
    return out


ordered_prefix_fill.launches = 0
ordered_place_i32.launches = 0
