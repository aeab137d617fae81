"""Tile binning: tile bbox -> per-tile depth-sorted key lists.

Port of the contract of ``taichi_3d_gaussian_splatting_tpu/ops/tiling.py``
(``tile_bbox``, ``build_tile_keys_and_table``), not of its TPU machinery.
Two sizings of the key buffer:

- exact (``key_cap=None``, every path but the windowed train step): the
  buffer is sized to the frame's key total (one host sync per frame), so
  no key is ever dropped and no capacity has to be fitted;
- capped (``key_cap`` an int, the JAX package's static capacity): the
  buffers are (key_cap,), the key total stays a device scalar that no host
  code reads, and no host sync is left, so a window of steps can be
  captured in one CUDA graph. Slots from min(total, key_cap) on hold the
  sentinel and sort after every tile; if the total exceeds key_cap, the
  surplus keys of the highest-index points (those of slots past key_cap)
  are dropped, as the JAX package drops them (the true total lets the
  trainer grow the capacity). ``TileKeys.counts`` stays the JAX package's
  unclipped per-point count (the ``num_overlap_tiles`` statistic);
  ``TileKeys.kept_counts`` is clipped on the device to the keys kept, so
  the backward's segment sum walks only slots below key_cap. With key_cap
  above the total, the sorted keys, table rows and tile ranges of the live
  keys are the exact path's, and so is every frame blended from them.

What matches the JAX package exactly: the per-point counts, offsets and
total; the fused key ``tid << dbits | dkey`` with the truncating
fixed-point depth key; the sentinel ``((num_tiles + 1) << dbits) - 1``;
the stable sort order (ties keep pre-sort slot order, and point p's j-th
key sits at slot offsets[p] + j); and the per-tile [start, end) ranges.

Stages: ``expand.slot_keys`` (K1a, a CUDA kernel) writes the fused key and
the owning point of every slot; one stable ``torch.sort`` orders the keys;
``expand.sorted_table`` (K1b) writes the blend table in sorted order;
``histogram.tile_ranges`` (K2) writes the per-tile ranges from the sorted
keys in one pass (the JAX package's histogram of the sorted tile ids and
its exclusive cumsum), and ``histogram.tile_counts`` summarizes those
ranges into the tile counters that ``ops/stages.py`` records (the keys of
the heaviest tile, the kept keys, the tiles that hold a key). The TPU
design wrote the table before the sort and let the sort carry it; here
nothing gathers the table. The backward reads its sorted per-key rows
through ``inverse_permutation`` of the sort's permutation
(``segment_reduce.segment_reduce_sorted``);
``regroup_rows_by_slot``, the JAX package's regroup to pre-sort order, is
kept for the tests.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import expand as expand_mod
from taichi_3d_gaussian_splatting_tpu_torch.ops import histogram as histogram_mod
from taichi_3d_gaussian_splatting_tpu_torch.ops import stages


def tile_wh(tile: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    """Normalize a tile spec (int = square, or (tile_w, tile_h)) to a pair."""
    if isinstance(tile, (tuple, list)):
        tw, th = tile
        return int(tw), int(th)
    return int(tile), int(tile)


class TileBBox(NamedTuple):
    """Inclusive-exclusive tile index bounds per point, shapes (N,) int32."""

    min_u: torch.Tensor
    max_u: torch.Tensor
    min_v: torch.Tensor
    max_v: torch.Tensor


def tile_bbox(uv: torch.Tensor, radius: torch.Tensor, width: int, height: int,
              tile) -> TileBBox:
    """Conservative tile bounding box of a splat. ``radius`` is either the
    per-axis (N, 2) cull radius or a scalar (N,) radius."""
    tile_w, tile_h = tile_wh(tile)
    tiles_u = width // tile_w
    tiles_v = height // tile_h
    if radius.dim() == 2:
        rx = torch.clamp_min(radius[:, 0], 1.0)
        ry = torch.clamp_min(radius[:, 1], 1.0)
    else:
        rx = ry = torch.clamp_min(radius, 1.0)
    min_u_px = torch.clamp_min(uv[:, 0] - rx, 0.0)
    max_u_px = uv[:, 0] + rx
    min_v_px = torch.clamp_min(uv[:, 1] - ry, 0.0)
    max_v_px = uv[:, 1] + ry

    def tdiv(x, t):
        return torch.div(x, t, rounding_mode="floor").to(torch.int32)

    min_tu = torch.clamp_max(tdiv(min_u_px, tile_w), tiles_u)
    max_tu = tdiv(max_u_px, tile_w) + 1
    max_tu = torch.clamp_max(torch.maximum(max_tu, min_tu + 1), tiles_u)
    min_tv = torch.clamp_max(tdiv(min_v_px, tile_h), tiles_v)
    max_tv = tdiv(max_v_px, tile_h) + 1
    max_tv = torch.clamp_max(torch.maximum(max_tv, min_tv + 1), tiles_v)
    # splats whose cull extent misses the image get an EMPTY box (their
    # alpha at any in-image pixel is below the 1/255 skip)
    empty = ((max_u_px <= 0.0) | (min_u_px >= width)
             | (max_v_px <= 0.0) | (min_v_px >= height))
    max_tu = torch.where(empty, min_tu, max_tu)
    max_tv = torch.where(empty, min_tv, max_tv)
    return TileBBox(min_tu, max_tu, min_tv, max_tv)


def _depth_bits(num_tiles: int) -> int:
    """Bits for the depth key beside the tile id in the fused int32 key."""
    tid_bits = max(int(num_tiles + 1).bit_length(), 1)
    return min(31 - tid_bits, 23)


class TileKeys(NamedTuple):
    """Depth-sorted per-tile key lists. Tile t's keys occupy
    [tile_start[t], tile_end[t]); keys retired by the exact cull and the
    capped path's padding hold the sentinel and sort after every tile's
    range. The buffers are (total,) on the exact path, (key_cap,) on the
    capped one."""

    fused: torch.Tensor       # (total,) int32 sorted fused keys
    orig_slot: torch.Tensor   # (total,) int64 pre-sort slot of each key
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_end: torch.Tensor    # (num_tiles,) int32
    offsets: torch.Tensor     # (N,) int32 exclusive cumsum of counts
    counts: torch.Tensor      # (N,) int32 per-point key counts (masked),
                              # the JAX package's, kept or dropped
    kept_counts: torch.Tensor # (N,) int32 the keys of each point below
                              # key_cap (the segment sum's lengths); the
                              # counts themselves on the exact path
    total: Union[int, torch.Tensor]  # number of keys: a host int, or on
                              # the capped path a () int64 device scalar,
                              # the true total (may exceed key_cap)


class PointKeyRanges(NamedTuple):
    """Per-point inputs of the key expansion, all (N,) int32."""

    counts: torch.Tensor
    offsets: torch.Tensor
    dkey: torch.Tensor        # clipped fixed-point depth key
    base: torch.Tensor        # first covered tile id
    h: torch.Tensor           # bbox height in tiles
    total: Union[int, torch.Tensor]  # host int; () int64 device scalar
                                     # with key_cap


def point_key_ranges(uv, depth, radius, visible, width: int, height: int,
                     tile, depth_to_sort_key_scale: float,
                     key_cap: Optional[int] = None) -> PointKeyRanges:
    """Tile bbox, key counts and slot offsets of every point. The key
    total is read to the host (the exact path's one sync), or with
    ``key_cap`` left on the device; the counts are not clipped here."""
    tile_w, tile_h = tile_wh(tile)
    tiles_u = width // tile_w
    dbits = _depth_bits(tiles_u * (height // tile_h))
    bbox = tile_bbox(uv, radius, width, height, tile)
    counts = (bbox.max_u - bbox.min_u) * (bbox.max_v - bbox.min_v)
    counts = torch.where(visible, counts, torch.zeros_like(counts))
    csum = torch.cumsum(counts, 0, dtype=torch.int64)
    if key_cap is not None:
        total = (csum[-1] if counts.numel()
                 else torch.zeros((), dtype=torch.int64, device=uv.device))
    else:
        total = int(csum[-1]) if counts.numel() else 0  # the one host sync
        if total >= 2 ** 31:
            raise ValueError(f"{total} tile keys overflow int32 key slots")
    offsets = (csum - counts).to(torch.int32)
    # int32(depth * scale) truncates toward zero, as the JAX astype does
    dkey = torch.clamp((depth * depth_to_sort_key_scale).to(torch.int32),
                       0, (1 << dbits) - 1)
    base = bbox.min_u + tiles_u * bbox.min_v
    h = bbox.max_v - bbox.min_v
    return PointKeyRanges(counts, offsets, dkey, base, h, total)


def build_tile_keys_and_table(
    uv: torch.Tensor,
    depth: torch.Tensor,
    radius: torch.Tensor,
    visible: torch.Tensor,
    width: int,
    height: int,
    tile,
    depth_to_sort_key_scale: float = 2.0 ** 10,
    attr_cols: Optional[torch.Tensor] = None,
    exact_tile_cull: bool = True,
    key_cap: Optional[int] = None,
) -> Tuple[TileKeys, torch.Tensor]:
    """Expand visible splats into depth-sorted per-tile keys and the sorted
    (16, total) blend table; (16, key_cap) on the capped path
    (``key_cap``, see the module docstring).

    ``attr_cols``: (10, N) f32 [u, v, conic_a, conic_b, conic_c,
    log(rescale*opacity), r, g, b, depth]; non-finite entries become 0.
    Without it the table rows are zero and the exact cull is off (it needs
    the conics). Table rows after sorting: 0..9 the attributes with the
    splat centre tile-local, 10 the point index, 11..15 zero.
    """
    tile_w, tile_h = tile_wh(tile)
    tiles_u = width // tile_w
    num_tiles = tiles_u * (height // tile_h)
    dbits = _depth_bits(num_tiles)
    sentinel = ((num_tiles + 1) << dbits) - 1

    if key_cap is not None and not 0 < key_cap < 2 ** 31:
        raise ValueError(f"key_cap={key_cap} outside int32 key slots")
    r = point_key_ranges(uv, depth, radius, visible, width, height, tile,
                         depth_to_sort_key_scale, key_cap)
    has_attrs = attr_cols is not None
    if not has_attrs:
        attr_cols = torch.zeros((10, uv.shape[0]), dtype=torch.float32,
                                device=uv.device)
    att = attr_cols.contiguous()  # non-finite entries: the kernels read 0
    capped = key_cap is not None
    fused, owner = expand_mod.slot_keys(
        r.offsets, r.counts, r.dkey, r.base, r.h, att,
        total=key_cap if capped else r.total, tiles_u=tiles_u, tile_w=tile_w,
        tile_h=tile_h, dbits=dbits, sentinel=sentinel,
        exact_cull=exact_tile_cull and has_attrs,
        key_total=r.total if capped else None)
    fused_s, perm = torch.sort(fused, stable=True)
    table_s = expand_mod.sorted_table(
        fused_s, perm, owner, att, tiles_u=tiles_u, tile_w=tile_w,
        tile_h=tile_h, dbits=dbits, sentinel=sentinel)
    bounds = histogram_mod.tile_ranges(fused_s, dbits, num_tiles)
    # the frame's tile counters (the heaviest tile's keys, the kept keys,
    # the tiles that hold a key), kept on the device by ops/stages.py
    stages.count(histogram_mod.TILE_COUNTS,
                 lambda out: histogram_mod.tile_counts(bounds, out),
                 bounds.device)
    kept = r.counts
    if capped:
        # the keys each point keeps below key_cap: min(end, cap) -
        # min(start, cap) of its slot range
        end = r.offsets.long() + r.counts
        kept = (torch.clamp_max(end, key_cap)
                - torch.clamp_max(r.offsets.long(), key_cap)).to(torch.int32)
    keys = TileKeys(
        fused=fused_s, orig_slot=perm, tile_start=bounds[:-1],
        tile_end=bounds[1:], offsets=r.offsets, counts=r.counts,
        kept_counts=kept, total=r.total,
    )
    return keys, table_s


def inverse_permutation(orig_slot: torch.Tensor) -> torch.Tensor:
    """(total,) int32 sorted position of each pre-sort slot: inv[orig_slot[i]]
    = i (the JAX package leaves this scatter to XLA)."""
    total = orig_slot.shape[0]
    inv = torch.empty((total,), dtype=torch.int32, device=orig_slot.device)
    inv[orig_slot] = torch.arange(total, dtype=torch.int32,
                                  device=orig_slot.device)
    return inv


def regroup_rows_by_slot(rows: torch.Tensor,
                         orig_slot: torch.Tensor) -> torch.Tensor:
    """(R, total) rows in sorted key order -> (R, total) in original
    (pre-sort) key order: out[:, orig_slot[i]] = rows[:, i]. Every slot
    appears once in ``orig_slot`` (the sort's permutation), so a scatter
    by it writes every output lane. Equal to ``rows[:, inv]`` with ``inv =
    inverse_permutation(orig_slot)``; the main path never builds it."""
    return torch.empty_like(rows).index_copy_(1, orig_slot, rows)


def build_tile_keys(uv, depth, radius, visible, width: int, height: int,
                    tile, depth_to_sort_key_scale: float = 2.0 ** 10) -> TileKeys:
    """Key structure only (no attribute table, no exact cull)."""
    keys, _ = build_tile_keys_and_table(
        uv, depth, radius, visible, width, height, tile,
        depth_to_sort_key_scale)
    return keys
