"""Ragged contiguous segment sum: per-key rows -> per-point rows.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/segment_reduce.py``
(``segment_reduce``). Point p owns the pre-sort key slots [offsets[p],
offsets[p] + counts[p]), contiguous; its row is the sum of its slots'
lanes. ``segment_reduce`` keeps the JAX contract (slot k is lane k);
``segment_reduce_sorted``, the backward's, reads rows in sorted key order
through the inverse of the sort's permutation (slot k is lane inv[k]), so
the rows need no regroup to pre-sort order first. Both add each segment's
lanes in slot order from 0.

CUDA tensors go to the kernel in ``csrc/segment_reduce.cu``; CPU tensors to
the plain versions below, which add in the same order and so give the same
bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build


def segment_reduce_plain(rows: torch.Tensor, offsets: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_reduce` (same contract): the
    j-th lane of every segment is added in step j, and 0 to the sums of
    shorter segments (a sum that starts at +0 is never -0, so adding 0
    leaves its bits)."""
    n = offsets.shape[0]
    out = torch.zeros((rows.shape[0], n), dtype=torch.float32,
                      device=rows.device)
    counts = counts.long()
    offsets = offsets.long()
    for j in range(int(counts.max()) if n else 0):
        live = counts > j
        lane = torch.where(live, offsets + j, 0)
        out += torch.where(live, rows[:, lane], 0.0)
    return out


def segment_reduce_sorted_plain(rows: torch.Tensor, inv: torch.Tensor,
                                offsets: torch.Tensor,
                                counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_reduce_sorted`: the rows in
    pre-sort order (``rows[:, inv]``, which is
    ``tiling.regroup_rows_by_slot(rows, orig_slot)``), then
    :func:`segment_reduce_plain`."""
    return segment_reduce_plain(rows.index_select(1, inv.long()), offsets,
                                counts)


def _check(rows, offsets, counts) -> None:
    cuda_build.require(rows, "rows", torch.float32, 2)
    cuda_build.require(offsets, "offsets", torch.int32, 1)
    cuda_build.require(counts, "counts", torch.int32, 1)
    if counts.shape != offsets.shape:
        raise ValueError(f"counts {tuple(counts.shape)} and offsets "
                         f"{tuple(offsets.shape)} differ")


def _launch(rows, inv: Optional[torch.Tensor], offsets, counts):
    n = offsets.shape[0]
    out = torch.empty((rows.shape[0], n), dtype=torch.float32,
                      device=rows.device)
    launch = cuda_build.bind("segment_reduce", "segment_reduce_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    err = launch(rows.data_ptr(), rows.shape[0], rows.shape[1],
                 None if inv is None else inv.data_ptr(), offsets.data_ptr(),
                 counts.data_ptr(), n, out.data_ptr(),
                 cuda_build.stream_of(rows))
    cuda_build.check(err, "segment_reduce")
    return out


def segment_reduce(rows: torch.Tensor, offsets: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """Per-point sums (R, N) of ``rows`` (R, cols) f32 over each point's
    segment [offsets[p], offsets[p] + counts[p]), with offsets and counts
    (N,) int32, non-negative, segments ending at or before ``cols``."""
    _check(rows, offsets, counts)
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, offsets, counts)
    out = _launch(rows, None, offsets, counts)
    segment_reduce.launches += 1
    return out


def segment_reduce_sorted(rows: torch.Tensor, inv: torch.Tensor,
                          offsets: torch.Tensor,
                          counts: torch.Tensor) -> torch.Tensor:
    """``out[r, p]`` = the sum over p's slots k, in slot order, of
    ``rows[r, inv[k]]``: ``rows`` (R, total) f32 in sorted key order,
    ``inv`` (total,) int32 the sorted position of each pre-sort slot
    (``tiling.inverse_permutation`` of the sort's permutation), offsets and
    counts as :func:`segment_reduce`'s."""
    _check(rows, offsets, counts)
    cuda_build.require(inv, "inv", torch.int32, 1)
    if inv.shape[0] != rows.shape[1]:
        raise ValueError(f"inv {tuple(inv.shape)} does not match rows "
                         f"{tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return segment_reduce_sorted_plain(rows, inv, offsets, counts)
    out = _launch(rows, inv, offsets, counts)
    segment_reduce_sorted.launches += 1
    return out


segment_reduce.launches = 0
segment_reduce_sorted.launches = 0
