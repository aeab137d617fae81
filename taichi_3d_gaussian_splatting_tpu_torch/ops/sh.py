"""Real spherical-harmonics basis to degree 3 (16 coefficients).

Port of ``taichi_3d_gaussian_splatting_tpu/ops/sh.py``; same coefficients
and sign conventions.
"""
from __future__ import annotations

import torch


def sh_basis(direction: torch.Tensor) -> torch.Tensor:
    """(..., 3) unnormalized view direction -> (..., 16) SH basis values.

    The direction is normalized internally; a zero direction (a point at the
    camera centre) gives a finite basis.
    """
    n = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    d = direction / torch.clamp_min(n, 1e-12)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    one = torch.ones_like(x)
    return torch.stack(
        [
            0.28209479177387814 * one,
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * x * z,
            0.54627421529603959 * xx - 0.54627421529603959 * yy,
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * x * y * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )
