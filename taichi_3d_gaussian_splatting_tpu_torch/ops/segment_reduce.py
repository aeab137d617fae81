"""Ragged contiguous segment sum: per-key rows -> per-point rows.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/segment_reduce.py``
(``segment_reduce``). Reduces per-key gradient rows, in original key order
where each point's keys are contiguous (lanes [offsets[p], offsets[p] +
counts[p])), to per-point rows. CUDA tensors go to the kernel in
``csrc/segment_reduce.cu`` (one thread per (row, point), lanes added in
order); CPU tensors to the plain version below (``index_add_``).
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build


def segment_reduce_plain(rows: torch.Tensor, offsets: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_reduce` (same contract)."""
    n = offsets.shape[0]
    counts = counts.long()
    point_of_lane = torch.repeat_interleave(
        torch.arange(n, device=rows.device), counts)
    seg_start = torch.cumsum(counts, 0) - counts
    lane = (offsets.long()[point_of_lane]
            + torch.arange(point_of_lane.shape[0], device=rows.device)
            - seg_start[point_of_lane])
    out = torch.zeros((rows.shape[0], n), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(1, point_of_lane, rows[:, lane])


def segment_reduce(rows: torch.Tensor, offsets: torch.Tensor,
                   counts: torch.Tensor) -> torch.Tensor:
    """Per-point sums (R, N) of ``rows`` (R, cols) f32 over each point's
    segment [offsets[p], offsets[p] + counts[p]), with offsets and counts
    (N,) int32, non-negative, segments ending at or before ``cols``."""
    cuda_build.require(rows, "rows", torch.float32, 2)
    cuda_build.require(offsets, "offsets", torch.int32, 1)
    cuda_build.require(counts, "counts", torch.int32, 1)
    if counts.shape != offsets.shape:
        raise ValueError(f"counts {tuple(counts.shape)} and offsets "
                         f"{tuple(offsets.shape)} differ")
    if rows.device.type == "cpu":
        return segment_reduce_plain(rows, offsets, counts)
    n = offsets.shape[0]
    out = torch.empty((rows.shape[0], n), dtype=torch.float32,
                      device=rows.device)
    launch = cuda_build.bind("segment_reduce", "segment_reduce_launch", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(rows.data_ptr(), rows.shape[0], rows.shape[1],
                 offsets.data_ptr(), counts.data_ptr(), n, out.data_ptr(),
                 cuda_build.stream_of(rows))
    segment_reduce.launches += 1
    cuda_build.check(err, "segment_reduce")
    return out


segment_reduce.launches = 0
