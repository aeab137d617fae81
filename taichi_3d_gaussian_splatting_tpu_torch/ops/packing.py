"""bf16 rounding and bf16-pair bit packing, as int32 bit operations.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/packing.py``, bit for bit
(NaN, +-inf, subnormals and ties included). There, r and g rode the TPU's
key sort as one f32-carried pair of bf16 halves (``pack_sort_colors``);
the port sorts the keys alone and writes the table after the sort, so the
render path only needs ``round_bf16``. The pair packs and the unpack keep
the JAX contract for callers that carry two rows in one lane.

A carrier is only moved or bit-manipulated, never fed to float arithmetic,
so a NaN-looking bit pattern in it is harmless.
"""
from __future__ import annotations

import torch

_HIGH = -65536           # 0xFFFF0000 as an int32
_LOW = 0xFFFF
_SIGN = -(2 ** 31)       # 0x80000000 as an int32
_QUIET_NAN = 0x7FC00000  # XLA's canonical bf16 NaN, widened


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _carrier(u: torch.Tensor) -> torch.Tensor:
    return u.contiguous().view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> nearest bf16 (ties to even), returned as the f32 it widens to.
    Subnormals round like normals; a NaN becomes the quiet NaN of its sign,
    as XLA's f32 -> bf16 convert gives it."""
    b = _bits(x.to(torch.float32))
    rounded = (b + (0x7FFF + ((b >> 16) & 1))) & _HIGH
    nan = (b & _SIGN) | _QUIET_NAN
    return _carrier(torch.where(torch.isnan(x), nan, rounded))


def pack_bf16_pair_rne(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(bf16_rne(a) << 16 | bf16_rne(b)) as an f32-carried bit pattern."""
    return _carrier(_bits(round_bf16(a))
                    | ((_bits(round_bf16(b)) >> 16) & _LOW))


def pack_bf16_pair_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncating variant (round-toward-zero in magnitude)."""
    return _carrier((_bits(a) & _HIGH) | ((_bits(b) >> 16) & _LOW))


def unpack_bf16_pair(p: torch.Tensor):
    """One f32 carrier -> (a, b) f32 rows; exact inverse of both packs."""
    u = _bits(p)
    return _carrier(u & _HIGH), _carrier((u & _LOW) << 16)
