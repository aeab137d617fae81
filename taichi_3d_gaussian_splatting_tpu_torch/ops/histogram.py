"""Bucket histogram: the per-tile key counts behind the tile ranges.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/histogram.py``
(``bucket_histogram``). CUDA tensors go to the kernel in
``csrc/histogram.cu``; CPU tensors to the plain version below.
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build


def bucket_histogram_plain(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Counts of each id in [0, num_buckets) as int32; other ids ignored."""
    keep = ids[(ids >= 0) & (ids < num_buckets)]
    return torch.bincount(keep.long(), minlength=num_buckets).to(torch.int32)


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Counts of each bucket id in [0, num_buckets) over a 1-D int32 tensor.
    Values outside the range are ignored."""
    cuda_build.require(ids, "ids", torch.int32, 1)
    if num_buckets < 0:
        raise ValueError(f"num_buckets must be >= 0, got {num_buckets}")
    if ids.device.type == "cpu":
        return bucket_histogram_plain(ids, num_buckets)
    out = torch.zeros((num_buckets,), dtype=torch.int32, device=ids.device)
    if ids.numel() == 0 or num_buckets == 0:
        return out
    launch = cuda_build.bind("histogram", "bucket_histogram_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p])
    err = launch(ids.data_ptr(), ids.numel(), num_buckets, out.data_ptr(),
                 cuda_build.stream_of(ids))
    bucket_histogram.launches += 1
    cuda_build.check(err, "bucket_histogram")
    return out


bucket_histogram.launches = 0
