"""Tile binning (port of ``gs_deformable_tpu/ops/binning.py``).

Expands each visible gaussian into one instance per touched tile, sorts the
instances by (tile, depth) and lays each tile's range out aligned: tile t
owns rows ``[tile_chunk_start[t] * chunk, + tile_count[t])`` of a static
``Kp``-row layout whose unset slots point at gaussian 0.  ``chunk`` is the
layout unit (``config.layout_unit``: ``sub_chunk`` under the packed
composite schedule).

The instance list has a static capacity K; ``required`` and
``total_aligned`` surface what the frame needed.  Two sort modes:

- ``"exact"`` (and "auto"/"radix"): instances are emitted in (depth, index)
  order and sorted stably by tile, CUB's exact (tile, depth) order; when
  more than K are needed the DEEPEST drop first.
- ``"packed"``: instances are emitted in gaussian-index order and sorted
  stably by one key, the tile above the depth's top 19 bits
  (binning.py:544-556 of the JAX package).  Depths that agree in those
  bits (within ~0.1%) keep emission order, and an overflow drops the
  instances of the highest gaussian indices.

The segment fills and the relayout place go through the ordered-fill CUDA
kernel (``ops/kernels/ordered_fill.py``) in the same three places as the
JAX version.  Everything is int32 and exact, and every output equals the
JAX function's bit for bit.  No step synchronises with the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .kernels.ordered_fill import ordered_place_i32, ordered_prefix_fill


class Binning(NamedTuple):
    gid: torch.Tensor  # (Kp,) int32 gaussian index per aligned instance slot
    tile_chunk_start: torch.Tensor  # (T,) int32 first chunk of each tile
    tile_count: torch.Tensor  # (T,) int32 instances in each tile
    num_instances: torch.Tensor  # () int32 instances emitted (<= K)
    required: torch.Tensor  # () int32 instances needed; > K means overflow
    total_aligned: torch.Tensor  # () int32 rows in use incl. padding (<= Kp)


def aligned_capacity(capacity: int, num_tiles: int, chunk: int, slack: int = -1) -> int:
    """Static padded capacity of the chunk-aligned layout.

    ``slack`` bounds the total per-tile padding; -1 is the worst case
    (every tile pads a whole chunk) and never overflows.
    """
    base = ((capacity + chunk - 1) // chunk) * chunk
    if slack < 0:
        slack = num_tiles * chunk
    slack = ((slack + chunk - 1) // chunk) * chunk
    return base + slack


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=0).to(torch.int32)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _prefix_fills(values, active, positions, K: int):
    """Fill K slots with per-segment constants whose active rows form a front prefix.

    Segment j (active) starts at ``positions[j]`` and carries
    ``values[i][j]``; positions >= K drop.  One prefix-fill launch of
    ``C = len(values)`` columns.  Returns a list of (K,) int32.
    """
    n = active.shape[0]
    npos = torch.arange(n, dtype=torch.int32, device=active.device)
    pos = torch.where(active, torch.minimum(positions, K + npos), K + npos)
    vblock = torch.stack(values, dim=1).to(torch.int32)
    delta = vblock - _shift_down(vblock)
    cols = ordered_prefix_fill(pos, delta, K)
    return list(cols.unbind(0))


def _delta_fills(values, active, positions, K: int):
    """``_prefix_fills`` for active rows anywhere: compact them to the front first.

    The compaction scatters into a 2n buffer (inactive rows land past n), so
    it needs no host-side count of the active rows.
    """
    n = active.shape[0]
    npos = torch.arange(n, dtype=torch.int32, device=active.device)
    arank = _cumsum_i32(active.to(torch.int32)) - 1
    slot = torch.where(active, arank, n + npos).long()

    def compact(v):
        out = torch.zeros(2 * n, dtype=torch.int32, device=v.device)
        return out.scatter_(0, slot, v.to(torch.int32))[:n]

    return _prefix_fills([compact(v) for v in values], npos <= arank[-1],
                         compact(positions), K)


def tile_bounds(tile_sorted: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """(T+1,) int32 bounds[t] = first index whose tile >= t (identifyTileRanges).

    Equal to the JAX ``tile_bounds_via_sort`` and to bisect_left for every
    t; entries of tile ``num_tiles`` (invalid slots) count toward the end.
    """
    tiles = torch.arange(num_tiles + 1, dtype=torch.int32, device=tile_sorted.device)
    return torch.searchsorted(tile_sorted, tiles, out_int32=True)


def _kth_set_bit(mask: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Position of the rank-th (0-based) set bit of a 16-bit mask."""
    bit = torch.zeros_like(mask)
    r = rank
    for half in (8, 4, 2, 1):
        low = (mask >> bit) & ((1 << half) - 1)
        c = _popcount16(low)
        go_high = r >= c
        bit = bit + torch.where(go_high, half, 0)
        r = r - torch.where(go_high, c, 0)
    return bit


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def bin_gaussians(tiles_touched: torch.Tensor, rect: torch.Tensor, depths: torch.Tensor,
                  *, grid_x: int, grid_y: int, capacity: int, chunk: int,
                  sort_mode: str = "exact", aligned_slack: int = -1,
                  tile_mask: Optional[torch.Tensor] = None) -> Binning:
    """(tile, depth)-sorted, chunk-aligned instance layout.

    tiles_touched (P,) int32 (0 = culled); rect (P, 4) int32 [x0, y0, x1, y1);
    depths (P,) float32; tile_mask optional (P,) int32 from
    ``projection.tile_ellipse_mask``.  ``sort_mode`` "exact", "auto" and
    "radix" all give the exact CUB order; "packed" the truncated-depth key
    (see module).
    """
    if sort_mode not in ("exact", "auto", "radix", "packed"):
        raise ValueError(f"unknown sort_mode {sort_mode!r}")
    packed = sort_mode == "packed"
    dev = tiles_touched.device
    P = tiles_touched.shape[0]
    K = capacity
    num_tiles = grid_x * grid_y
    if packed and num_tiles >= (1 << 13):
        # binning.py:549 of the JAX package: the key keeps 13 bits of tile.
        raise ValueError(f"sort_mode='packed' takes fewer than 8192 tiles, got {num_tiles}")
    Kp = aligned_capacity(K, num_tiles, chunk, aligned_slack)

    t = tiles_touched.to(torch.int32)
    ids = torch.arange(P, dtype=torch.int32, device=dev)
    w_t = torch.clamp(rect[:, 2] - rect[:, 0], min=1)
    small_grid = num_tiles < (1 << 13) and grid_x <= (1 << 10)
    if small_grid:
        code = ((rect[:, 1] * grid_x + rect[:, 0]) << 10) | w_t
    else:
        code = (rect[:, 0] << 20) | (rect[:, 1] << 10) | w_t

    code = code.to(torch.int32)
    if not packed:
        # Rank-major front end: emitting gaussians first, in (depth, index)
        # order; two stable sorts give the JAX two-key stable sort's order.
        by_depth = torch.sort(depths, stable=True).indices
        inactive = (t[by_depth] <= 0).to(torch.int32)
        perm = by_depth[torch.sort(inactive, stable=True).indices]
        ids, t, code = ids[perm], t[perm], code[perm]
        if tile_mask is not None:
            tile_mask = tile_mask[perm]

    cum = _cumsum_i32(t)
    offsets = cum - t
    required = cum[-1] if P > 0 else torch.zeros((), dtype=torch.int32, device=dev)

    vals = [ids, offsets, code]
    if packed:  # the depth's bits ride along as a fourth column
        vals.append(depths.contiguous().view(torch.int32))
    if tile_mask is not None:
        vals.append(tile_mask)
    # Packed emission is in index order, so the emitting rows are not a
    # front prefix: _delta_fills compacts them first.
    fills = (_delta_fills if packed else _prefix_fills)(vals, t > 0, offsets, K)
    safe_gid, offs, ic = fills[:3]
    pos = torch.arange(K, dtype=torch.int32, device=dev)
    valid = pos < torch.clamp(required, max=K)
    rank = pos - offs
    if tile_mask is not None:
        imask = fills[-1]
        flagged = (imask >> 16) > 0
        rank = torch.where(flagged, _kth_set_bit(imask & 0xFFFF, rank), rank)

    # Emission is y-outer / x-inner over the rect.  Slots past the emitted
    # instances hold stale codes; clamp the width so they divide safely.
    iw = torch.clamp(ic & 0x3FF, min=1)
    if small_grid:
        tile_id = (ic >> 10) + torch.div(rank, iw, rounding_mode="floor") * grid_x \
            + torch.remainder(rank, iw)
    else:
        iy0 = (ic >> 10) & 0x3FF
        ix0 = ic >> 20
        tile_id = (iy0 + torch.div(rank, iw, rounding_mode="floor")) * grid_x \
            + (ix0 + torch.remainder(rank, iw))
    tile_id = torch.where(valid, tile_id, num_tiles).to(torch.int32)

    if packed:
        # One stable sort on [tile | depth bits 13..31]; invalid slots carry
        # tile num_tiles and depth +inf, as binning.py:539-541 does.
        dbits = torch.where(valid, fills[3], 0x7F800000)
        key = (tile_id.long() << 19) | ((dbits >> 13) & 0x7FFFF).long()
        key_sorted, order = torch.sort(key, stable=True)
        tile_sorted = (key_sorted >> 19).to(torch.int32)
    else:
        # Stable sort on the tile id of the rank-major stream = CUB's order.
        tile_sorted, order = torch.sort(tile_id, stable=True)
    gid_sorted = safe_gid[order]
    bounds = tile_bounds(tile_sorted, num_tiles)
    tile_start = bounds[:-1]
    tile_count = bounds[1:] - bounds[:-1]
    num_instances = torch.clamp(required, max=K).to(torch.int32)

    chunks_per_tile = torch.div(tile_count + chunk - 1, chunk, rounding_mode="floor")
    chunk_start = _cumsum_i32(chunks_per_tile) - chunks_per_tile
    total_aligned = (chunk_start[-1] + chunks_per_tile[-1]) * chunk

    start_fill, chunk_base = _delta_fills(
        [tile_start, chunk_start], tile_count > 0, tile_start, K)
    rank_in_tile = pos - start_fill
    in_tile = tile_sorted < num_tiles
    new_pos = torch.where(
        in_tile, torch.minimum(chunk_base * chunk + rank_in_tile, Kp + pos), Kp + pos)
    gid_aligned = ordered_place_i32(new_pos.to(torch.int32), gid_sorted, Kp)

    return Binning(
        gid=gid_aligned,
        tile_chunk_start=chunk_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        num_instances=num_instances,
        required=required.to(torch.int32),
        total_aligned=total_aligned.to(torch.int32),
    )
