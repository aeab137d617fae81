"""Pinhole projection and EWA covariance splatting, batched torch.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/projection.py`` (the
component forms the render path uses). Every clamp and guard of the JAX
file is kept: they decide which rows of a dense all-slot projection turn
into NaN or inf, and so which points the tiling stage can see.
"""
from __future__ import annotations

import torch

# Low-pass filter added to the projected 2D covariance diagonal so every
# Gaussian is at least ~1px wide.
COV2D_FILTER = 0.3


def _away_from_zero(z: torch.Tensor) -> torch.Tensor:
    """|z| clamped to >= 1e-6 with its sign kept (1/z stays finite for
    culled points that cross the camera plane)."""
    return torch.where(z.abs() < 1e-6,
                       torch.where(z < 0, -1e-6, 1e-6).to(z.dtype), z)


def project_point(xyz: torch.Tensor, R_cw: torch.Tensor, t_cw: torch.Tensor,
                  K: torch.Tensor):
    """World point -> (uv (..., 2), xyz_cam (..., 3)).

    R_cw/t_cw: world->camera rotation (3, 3) and translation (3,), or one
    per point, (..., 3, 3) and (..., 3); K: (3, 3) intrinsics.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    R, t = R_cw, t_cw
    cx = R[..., 0, 0] * x + R[..., 0, 1] * y + R[..., 0, 2] * z + t[..., 0]
    cy = R[..., 1, 0] * x + R[..., 1, 1] * y + R[..., 1, 2] * z + t[..., 1]
    cz = R[..., 2, 0] * x + R[..., 2, 1] * y + R[..., 2, 2] * z + t[..., 2]
    inv = 1.0 / _away_from_zero(cz)
    u = (K[0, 0] * cx + K[0, 1] * cy + K[0, 2] * cz) * inv
    v = (K[1, 0] * cx + K[1, 1] * cy + K[1, 2] * cz) * inv
    return torch.stack([u, v], dim=-1), torch.stack([cx, cy, cz], dim=-1)


def project_cov2d_components(q: torch.Tensor, log_scale: torch.Tensor,
                             R_cw: torch.Tensor, K: torch.Tensor,
                             xyz_cam: torch.Tensor):
    """EWA covariance cov2d = B B^T, B = (J R_cw)(R(q) diag(exp(s))), as
    explicit per-component formulas: returns (a, b, c), each 1-D. R_cw is
    (3, 3), or (..., 3, 3) with one rotation per point."""
    fx = K[0, 0]
    fy = K[1, 1]
    x, y = xyz_cam[..., 0], xyz_cam[..., 1]
    # 1e-6 (not smaller): the squared Jacobian terms carry inv_z^4, which
    # must stay inside f32 range
    inv_z = 1.0 / _away_from_zero(xyz_cam[..., 2])
    jx = fx * inv_z
    jy = fy * inv_z
    jxz = -fx * x * inv_z * inv_z
    jyz = -fy * y * inv_z * inv_z

    r0, r1, r2 = R_cw[..., 0, :], R_cw[..., 1, :], R_cw[..., 2, :]
    A0 = [jx * r0[..., i] + jxz * r2[..., i] for i in range(3)]
    A1 = [jy * r1[..., i] + jyz * r2[..., i] for i in range(3)]

    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    R = [
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ]
    s = (torch.exp(log_scale[..., 0]), torch.exp(log_scale[..., 1]),
         torch.exp(log_scale[..., 2]))

    def brow(A):
        return [(A[0] * R[0][k] + A[1] * R[1][k] + A[2] * R[2][k]) * s[k]
                for k in range(3)]

    B0 = brow(A0)
    B1 = brow(A1)
    a = B0[0] * B0[0] + B0[1] * B0[1] + B0[2] * B0[2]
    b = B0[0] * B1[0] + B0[1] * B1[1] + B0[2] * B1[2]
    c = B1[0] * B1[0] + B1[1] * B1[1] + B1[2] * B1[2]
    return a, b, c


def conic_rescale_radius_components(a, b, c):
    """(a, b, c) -> (conic_a, conic_b, conic_c, rescale, radius), all 1-D."""
    # clamp so af*cf and b^2 stay inside f32 range (a point crossing the
    # camera plane gives cov entries of 1e25 and more)
    a = torch.clamp(a, -1e18, 1e18)
    b = torch.clamp(b, -1e18, 1e18)
    c = torch.clamp(c, -1e18, 1e18)
    det_prefilter = a * c - b * b
    af = a + COV2D_FILTER
    cf = c + COV2D_FILTER
    # floor: f32 cancellation at 1e36 magnitudes can give det <= 0
    det = torch.clamp_min(af * cf - b * b, 1e-6)
    ratio = torch.clamp_min(det_prefilter / det, 0.0)
    rescale = torch.where(ratio > 0.0, torch.sqrt(torch.clamp_min(ratio, 1e-30)),
                          torch.zeros_like(ratio))
    inv_det = 1.0 / det
    lam_max = (a + c + torch.sqrt((a - c) * (a - c) + 4.0 * b * b)) / 2.0
    radius = torch.sqrt(torch.clamp_min(lam_max, 0.0)) * 3.0
    return cf * inv_det, -b * inv_det, af * inv_det, rescale, radius
