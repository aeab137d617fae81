"""Quaternion / SE(3) math, batched over arbitrary leading axes.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/transforms.py``.
Quaternions are stored **xyzw** (the feature layout of the scene).
All functions are plain torch, f32, and broadcast over leading batch axes.
"""
from __future__ import annotations

import torch


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw -> (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) xyzw, branch-free 4-case selection (the case
    with the largest pivot)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12)) * 2.0

    sw = root(tr + 1.0)
    qw_w, qx_w, qy_w, qz_w = 0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw
    sx = root(1.0 + m00 - m11 - m22)
    qw_x, qx_x, qy_x, qz_x = (m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx
    sy = root(1.0 - m00 + m11 - m22)
    qw_y, qx_y, qy_y, qz_y = (m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy
    sz = root(1.0 - m00 - m11 + m22)
    qw_z, qx_z, qy_z, qz_z = (m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz

    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)

    def pick(w, x, y, z):
        return torch.where(use_w, w, torch.where(use_x, x, torch.where(use_y, y, z)))

    q = torch.stack(
        [pick(qx_w, qx_x, qx_y, qx_z), pick(qy_w, qy_x, qy_y, qy_z),
         pick(qz_w, qz_x, qz_y, qz_z), pick(qw_w, qw_x, qw_y, qw_z)],
        dim=-1,
    )
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product, xyzw."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    # negation, not a product with a host constant: the train step makes
    # no host-to-device copy, so a CUDA graph can capture it
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quaternion_exp(omega: torch.Tensor) -> torch.Tensor:
    """so(3) exponential map: axis-angle (3,) -> unit quaternion xyzw, with a
    2nd-order Taylor branch near zero (exact value and gradient at 0)."""
    t2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(t2, 1e-24))  # guarded: unused branch only
    small = t2 < 1e-12
    s = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * theta) / theta)
    c = torch.where(small[..., 0], 1.0 - t2[..., 0] / 8.0,
                    torch.cos(0.5 * theta[..., 0]))
    return torch.cat([s * omega, c[..., None]], dim=-1)


def apply_pose_delta(q: torch.Tensor, t: torch.Tensor, d: torch.Tensor):
    """Compose a camera pose (q xyzw, t) with an se(3) refinement delta
    d = (omega xyz, dt xyz): q' = normalize(q * exp(omega)), t' = t + dt."""
    qq = quaternion_multiply(q.reshape(4), quaternion_exp(d[:3]))
    qq = qq / torch.linalg.vector_norm(qq)
    return qq, t.reshape(3) + d[3:]


def quaternion_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4) xyzw."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def _bottom_row(ref: torch.Tensor) -> torch.Tensor:
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=ref.dtype, device=ref.device)
    return row.expand(ref.shape[:-2] + (1, 4))


def se3_from_qt(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(q xyzw, t) -> 4x4 homogeneous transform."""
    top = torch.cat([quaternion_to_rotation_matrix(q), t[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def inverse_se3(T: torch.Tensor) -> torch.Tensor:
    """Invert a rigid 4x4."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    t_new = -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    top = torch.cat([Rt, t_new[..., :, None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def inverse_qt(q: torch.Tensor, t: torch.Tensor):
    """Inverse of the rigid transform given as (q, t)."""
    q_inv = quaternion_conjugate(q)
    return q_inv, -quaternion_rotate(q_inv, t)


def se3_to_qt(T: torch.Tensor):
    """4x4 -> (q xyzw, t)."""
    return rotation_matrix_to_quaternion(T[..., :3, :3]), T[..., :3, 3]
