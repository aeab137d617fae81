"""Tile ranges of the sorted keys, and the bucket histogram behind them.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/histogram.py``
(``bucket_histogram``), whose exclusive cumsum over the sorted tile ids the
JAX package takes as the per-tile key ranges in place of ``searchsorted``.
Every path calls ``tile_ranges``, which computes those ranges straight
from the sorted fused keys in one pass: CUDA tensors go to its kernel in
``csrc/histogram.cu``, CPU tensors to its plain version below.
``bucket_histogram`` keeps the JAX function's contract for unsorted ids,
in plain torch on either device (no path runs it).
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Counts of each bucket id in [0, num_buckets) over a 1-D int32 tensor,
    as int32. Values outside the range are ignored."""
    cuda_build.require(ids, "ids", torch.int32, 1)
    if num_buckets < 0:
        raise ValueError(f"num_buckets must be >= 0, got {num_buckets}")
    keep = ids[(ids >= 0) & (ids < num_buckets)]
    return torch.bincount(keep.long(), minlength=num_buckets).to(torch.int32)


def tile_ranges_plain(fused_sorted: torch.Tensor, dbits: int,
                      num_tiles: int) -> torch.Tensor:
    """searchsorted(fused_sorted >> dbits, [0, num_tiles], side='left') as
    int32: entry b counts the keys whose tile is below b."""
    tid = (fused_sorted >> dbits).contiguous()
    b = torch.arange(num_tiles + 1, dtype=torch.int32,
                     device=fused_sorted.device)
    return torch.searchsorted(tid, b, side="left", out_int32=True)


def tile_ranges(fused_sorted: torch.Tensor, dbits: int,
                num_tiles: int) -> torch.Tensor:
    """(num_tiles + 1,) int32 bounds of the per-tile key ranges of the
    ascending non-negative fused keys ``tile << dbits | depth``: tile t
    owns [bounds[t], bounds[t + 1]), and bounds[num_tiles] counts the keys
    below the sentinel tile num_tiles. Equal to the exclusive cumsum of
    ``bucket_histogram(fused_sorted >> dbits, num_tiles)``."""
    cuda_build.require(fused_sorted, "fused_sorted", torch.int32, 1)
    if num_tiles < 0 or not 0 <= dbits < 31:
        raise ValueError(f"need num_tiles >= 0 and 0 <= dbits < 31, got "
                         f"{num_tiles}, {dbits}")
    if fused_sorted.device.type == "cpu":
        return tile_ranges_plain(fused_sorted, dbits, num_tiles)
    total = fused_sorted.numel()
    if total >= 2 ** 31:
        raise ValueError(f"{total} keys overflow the int32 bounds")
    bounds = torch.empty((num_tiles + 1,), dtype=torch.int32,
                         device=fused_sorted.device)
    launch = cuda_build.bind("histogram", "tile_ranges_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    err = launch(fused_sorted.data_ptr(), total, dbits, num_tiles,
                 bounds.data_ptr(), cuda_build.stream_of(fused_sorted))
    tile_ranges.launches += 1
    cuda_build.check(err, "tile_ranges")
    return bounds


tile_ranges.launches = 0

TILE_COUNTS = ("tile_keys_max", "tile_keys_kept", "tiles_nonempty")


def tile_counts_plain(bounds: torch.Tensor, out: torch.Tensor) -> None:
    """Writes into ``out`` ((3,) int64) the summary of the tile ranges
    ``bounds`` (``tile_ranges``): the keys of the heaviest tile, the kept
    keys (every key below the sentinel tile) and the tiles that hold a key,
    in the order of ``TILE_COUNTS``."""
    n = (bounds[1:] - bounds[:-1]).to(torch.int64)
    heaviest = n.max() if n.numel() else n.new_zeros(())
    out.copy_(torch.stack([heaviest, n.sum(), (n > 0).sum()]))


def tile_counts(bounds: torch.Tensor, out: torch.Tensor) -> None:
    """``tile_counts_plain`` for CPU tensors, one launch of
    ``csrc/histogram.cu``'s ``tile_counts_kernel`` for CUDA ones (no host
    sync: the counters stay on the device)."""
    cuda_build.require(bounds, "bounds", torch.int32, 1)
    cuda_build.require(out, "out", torch.int64, 1)
    if out.numel() != len(TILE_COUNTS) or bounds.numel() < 1:
        raise ValueError(
            f"need (num_tiles + 1,) bounds and ({len(TILE_COUNTS)},) out, "
            f"got {tuple(bounds.shape)}, {tuple(out.shape)}")
    if bounds.device.type == "cpu":
        tile_counts_plain(bounds, out)
        return
    launch = cuda_build.bind("histogram", "tile_counts_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(bounds.data_ptr(), bounds.numel() - 1, out.data_ptr(),
                 cuda_build.stream_of(bounds))
    tile_counts.launches += 1
    cuda_build.check(err, "tile_counts")


tile_counts.launches = 0
