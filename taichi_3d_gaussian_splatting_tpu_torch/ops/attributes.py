"""Per-point screen-space attributes over every pool slot, dense torch.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/attributes.py``. Invalid and
invisible slots are projected too and masked downstream.

Feature layout:
  feat[0:4]   quaternion xyzw
  feat[4:7]   log scale
  feat[7]     pre-sigmoid opacity
  feat[8:24]  SH coefficients, R channel (band <= 3)
  feat[24:40] SH G
  feat[40:56] SH B
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import projection as proj
from taichi_3d_gaussian_splatting_tpu_torch.ops.sh import sh_basis
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    quaternion_to_rotation_matrix,
)

# SH band of each of the 16 coefficients.
_COEFF_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)


class PointAttributes(NamedTuple):
    """Screen-space attributes, one row per pool slot (all shapes (N, ...))."""

    uv: torch.Tensor           # (N, 2) pixel coords of the projected center
    xyz_cam: torch.Tensor      # (N, 3) camera-frame position (z = depth)
    cov2d: torch.Tensor        # (N, 3) projected covariance (a, b, c), unfiltered
    conic: torch.Tensor        # (N, 4) filtered inverse cov (a, b, c) + rescale
    opacity: torch.Tensor      # (N,)  sigmoid(alpha)
    color: torch.Tensor        # (N, 3) SH color along camera->point ray
    radius: torch.Tensor       # (N,)  conservative splat radius in pixels
    radius_xy: torch.Tensor    # (N, 2) per-axis output-lossless cull radius


def compute_point_attributes(
    xyz: torch.Tensor,            # (N, 3)
    features: torch.Tensor,       # (N, 56)
    q_cam: torch.Tensor,          # (4,) or (N, 4) world->camera rotation, xyzw
    t_cam: torch.Tensor,          # (3,) or (N, 3) world->camera translation
    K: torch.Tensor,              # (3, 3)
    camera_center: torch.Tensor,  # (3,) or (N, 3) camera origin, world frame
    sh_max_band: int = 3,
) -> PointAttributes:
    """Project every pool slot to screen space. ``sh_max_band`` masks the SH
    bands above it. A pose given per point (the JAX package's per-object
    poses, which it maps over points) broadcasts through the same
    elementwise formulas."""
    R_cw = quaternion_to_rotation_matrix(q_cam)

    quat = features[:, 0:4]
    # guarded normalize: zero-padded invalid rows would otherwise give 0/0
    quat = quat / torch.clamp_min(
        torch.linalg.vector_norm(quat, dim=-1, keepdim=True), 1e-12)
    log_scale = features[:, 4:7]
    alpha_logit = features[:, 7]
    sh = features[:, 8:56].reshape(-1, 3, 16)

    uv, xyz_cam = proj.project_point(xyz, R_cw, t_cam, K)
    a, b, c = proj.project_cov2d_components(quat, log_scale, R_cw, K, xyz_cam)
    ca, cb, cc, rescale, radius = proj.conic_rescale_radius_components(a, b, c)
    conic = torch.stack([ca, cb, cc, rescale], dim=-1)
    cov2d = torch.stack([a, b, c], dim=-1)

    opacity = torch.sigmoid(alpha_logit)

    # Per-axis output-lossless cull radius: the blend skips alpha < 1/255,
    # and the axis extent of {q <= qm} of the filtered quadratic is
    # sqrt(qm * Sigma_axis), so tiles beyond it hold only skipped pixels.
    qm = 2.0 * torch.log(torch.clamp_min(255.0 * conic[:, 3] * opacity, 1e-30))
    qm = torch.clamp_min(qm, 0.0)
    af = cov2d[:, 0] + proj.COV2D_FILTER
    cf = cov2d[:, 2] + proj.COV2D_FILTER
    rx = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(af, 0.0)))
    ry = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(cf, 0.0)))
    radius_xy = torch.stack([rx, ry], dim=-1)

    basis = sh_basis(xyz - camera_center)  # (N, 16)
    band_mask = _sh_band_mask(sh_max_band, basis.dtype, basis.device)
    raw = torch.sum(sh * (basis * band_mask)[:, None, :], dim=-1)
    color = torch.sigmoid(raw)

    return PointAttributes(
        uv=uv, xyz_cam=xyz_cam, cov2d=cov2d, conic=conic,
        opacity=opacity, color=color, radius=radius, radius_xy=radius_xy,
    )


def _sh_band_mask(max_band: int, dtype, device) -> torch.Tensor:
    """(16,) mask keeping coefficients of bands <= max_band: band b holds
    coefficients [b^2, (b + 1)^2) (``_COEFF_BAND``). Made on the device, so
    no host copy (which a CUDA graph could not capture) feeds the step."""
    keep = (int(max_band) + 1) ** 2
    return (torch.arange(len(_COEFF_BAND), device=device) < keep).to(dtype)


def frustum_cull_mask(
    uv: torch.Tensor,
    depth: torch.Tensor,
    invalid_mask: torch.Tensor,
    width: int,
    height: int,
    near: float,
    far: float,
    tile_size: Union[int, Tuple[int, int]],
    boundary_tiles: int = 3,
    boundary_tiles_v: int | None = None,
) -> torch.Tensor:
    """Visibility mask: near < z < far and the projected center inside the
    image padded by ``boundary_tiles`` tiles. The default vertical pad uses
    tile_w for both axes; ``boundary_tiles_v`` overrides it in tile rows."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.tiling import tile_wh
    tile_w, tile_h = tile_wh(tile_size)
    pad_u = tile_w * boundary_tiles
    pad_v = (tile_w * boundary_tiles if boundary_tiles_v is None
             else tile_h * boundary_tiles_v)
    in_depth = (depth > near) & (depth < far)
    in_u = (uv[:, 0] >= -pad_u) & (uv[:, 0] < width + pad_u)
    in_v = (uv[:, 1] >= -pad_v) & (uv[:, 1] < height + pad_v)
    return in_depth & in_u & in_v & ~invalid_mask
