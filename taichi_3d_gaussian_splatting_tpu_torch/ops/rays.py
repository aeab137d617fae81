"""Ray generation and ray-ellipsoid intersection, batched torch.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/rays.py``: helpers for
picking and camera interaction, branch-free and broadcasting over leading
batch axes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    inverse_se3,
    quaternion_to_rotation_matrix,
)


def ray_from_pixel(
    uv: torch.Tensor,                  # (..., 2) integer or float pixel coords
    camera_intrinsics: torch.Tensor,   # (3, 3)
    T_camera_pointcloud: torch.Tensor,  # (4, 4) world->camera
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origin (..., 3), unit direction (..., 3)) in the world frame,
    through the pixel centres (+0.5)."""
    fx = camera_intrinsics[0, 0]
    fy = camera_intrinsics[1, 1]
    cx = camera_intrinsics[0, 2]
    cy = camera_intrinsics[1, 2]
    center = uv.to(camera_intrinsics.dtype) + 0.5
    d_cam = torch.stack(
        [(center[..., 0] - cx) / fx, (center[..., 1] - cy) / fy,
         torch.ones_like(center[..., 0])], dim=-1)
    T_pc = inverse_se3(T_camera_pointcloud)
    origin = torch.broadcast_to(T_pc[:3, 3], d_cam.shape)
    direction = torch.einsum("ij,...j->...i", T_pc[:3, :3], d_cam)
    direction = direction / torch.linalg.vector_norm(direction, dim=-1,
                                                     keepdim=True)
    return origin, direction


def intersect_ray_with_ellipsoid(
    ray_origin: torch.Tensor,      # (..., 3)
    ray_direction: torch.Tensor,   # (..., 3)
    ellipsoid_R: torch.Tensor,     # (..., 3, 3)
    ellipsoid_t: torch.Tensor,     # (..., 3)
    ellipsoid_S: torch.Tensor,     # (..., 3) semi-axes
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit (...,) bool, intersection point (..., 3), zero where missed).

    Takes the ray into the unit-sphere frame and solves the quadratic,
    keeping the nearest non-negative root (with the eps clamps of A and of
    the discriminant)."""
    Rt = ellipsoid_R.transpose(-1, -2)
    o_local = torch.einsum("...ij,...j->...i", Rt,
                           ray_origin - ellipsoid_t) / ellipsoid_S
    d_local = torch.einsum("...ij,...j->...i", Rt, ray_direction) / ellipsoid_S

    A = torch.sum(d_local * d_local, dim=-1)
    A = torch.where(A.abs() < eps, torch.full_like(A, eps), A)
    B = 2.0 * torch.sum(o_local * d_local, dim=-1)
    C = torch.sum(o_local * o_local, dim=-1) - 1.0

    disc = B * B - 4.0 * A * C
    disc_c = torch.where(disc.abs() < eps, torch.zeros_like(disc), disc)
    sqrt_disc = torch.sqrt(torch.clamp_min(disc_c, 0.0))
    t1 = (-B - sqrt_disc) / (2.0 * A)
    t2 = (-B + sqrt_disc) / (2.0 * A)
    t_near = torch.where(t1 >= 0, t1, t2)
    t_near = torch.where((t1 - t2).abs() < eps, torch.minimum(t1, t2), t_near)

    hit = (disc >= 0) & ((t1 >= 0) | (t2 >= 0))
    p_local = o_local + t_near[..., None] * d_local
    point = torch.einsum("...ij,...j->...i", ellipsoid_R,
                         p_local * ellipsoid_S) + ellipsoid_t
    return hit, torch.where(hit[..., None], point, torch.zeros_like(point))


def intersect_ray_with_gaussian(ray_origin, ray_direction, q, log_scale, xyz,
                                eps: float = 1e-5):
    """:func:`intersect_ray_with_ellipsoid` for a Gaussian given as (q xyzw,
    log_scale, xyz), the scene's feature layout."""
    R = quaternion_to_rotation_matrix(q)
    S = torch.exp(log_scale)
    return intersect_ray_with_ellipsoid(ray_origin, ray_direction, R, xyz, S,
                                        eps)
