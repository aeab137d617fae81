"""Dense torch reference blender: the behavioural oracle of the blend.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/blend_reference.py``:
- alpha = pdf_conic(pixel) * rescale * sigmoid(opacity);
- contributions with alpha < 1/255 are skipped entirely (no T update);
- alpha is clamped at 0.99, straight-through for gradients;
- blending stops for good once T would drop below 1e-4: the triggering
  point and every later one are excluded;
- pixel centers at +0.5; no background (color starts at 0);
- depth is alpha-weighted, normalized by max(sum w, 1e-6).

The pixel state machine is one cumulative product P_i = prod_{j<=i}(1-a_j)
(a_j = 0 when skipped): T_i = P_{i-1}, the inclusion mask is P_i >= 1e-4,
and the final transmittance is P at the last included point.

O(pixels x points): for tests and tiny scenes only.
"""
from __future__ import annotations

import torch

ALPHA_SKIP_EPS = 1.0 / 255.0
ALPHA_CLAMP = 0.99
T_SATURATION_EPS = 1e-4


def straight_through_clamp(a: torch.Tensor) -> torch.Tensor:
    """min(a, 0.99) in value, the identity in gradient."""
    return a - (a - a.clamp_max(ALPHA_CLAMP)).detach()


def blend_dense(
    pixel_xy: torch.Tensor,   # (P, 2) pixel centers (+0.5 already applied)
    member: torch.Tensor,     # (P, L) bool: point may contribute to pixel
    uv: torch.Tensor,         # (L, 2) depth-ordered splat centers
    conic: torch.Tensor,      # (L, 4) (a, b, c, rescale)
    opacity: torch.Tensor,    # (L,) sigmoid opacity
    color: torch.Tensor,      # (L, 3)
    depth: torch.Tensor,      # (L,)
):
    """Blend L depth-ordered splats into P pixels; returns per-pixel
    (rgb, depth, alpha, count, w_sum)."""
    dx = pixel_xy[:, 0:1] - uv[None, :, 0]
    dy = pixel_xy[:, 1:2] - uv[None, :, 1]
    a_, b_, c_, resc = conic[:, 0], conic[:, 1], conic[:, 2], conic[:, 3]
    expo = (-0.5 * (dx * dx * a_[None, :] + dy * dy * c_[None, :])
            - dx * dy * b_[None, :])
    alpha_u = torch.exp(expo) * (resc * opacity)[None, :]
    alpha_u = torch.where(member, alpha_u, torch.zeros_like(alpha_u))

    skip = ~(alpha_u >= ALPHA_SKIP_EPS)  # not(>=) catches NaN
    a = torch.where(skip, torch.zeros_like(alpha_u),
                    straight_through_clamp(alpha_u))
    one_minus = 1.0 - a
    p_incl = torch.cumprod(one_minus, dim=1)
    T = p_incl / one_minus  # exclusive product; 1 - a >= 0.01
    include = ~skip & (p_incl >= T_SATURATION_EPS)
    w = torch.where(include, a * T, torch.zeros_like(a))

    rgb = w @ color
    w_sum = torch.sum(w, dim=1)
    depth_out = (w @ depth) / torch.clamp_min(w_sum, 1e-6)
    T_final = torch.prod(torch.where(include, one_minus,
                                     torch.ones_like(one_minus)), dim=1)
    count = torch.sum(include, dim=1).to(torch.int32)
    return rgb, depth_out, 1.0 - T_final, count, w_sum


def render_reference(xyz, features, invalid_mask, q_pointcloud_camera,
                     t_pointcloud_camera, camera, cfg, sh_max_band=3):
    """Full-image oracle renderer, O(pixels x points): the production
    membership rule and the per-tile depth order (a global stable sort of
    the clipped depth key) with dense torch only. Returns (rgb, depth,
    alpha, count) images."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling
    from taichi_3d_gaussian_splatting_tpu_torch.ops.attributes import (
        frustum_cull_mask,
        point_attributes_plain,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import RawAttrs

    tile_w, tile_h = tiling.tile_wh(
        (cfg.tile_size, cfg.tile_size if cfg.tile_h is None else cfg.tile_h))
    # the plain attributes, so the card tests that hold the kernels against
    # this oracle do not share the attribute kernel
    *fields, radius = point_attributes_plain(
        xyz, features, q_pointcloud_camera, t_pointcloud_camera, camera.K,
        sh_max_band, camera.row0)
    raw = RawAttrs(*fields)
    visible = frustum_cull_mask(
        raw.uv, raw.depth, invalid_mask, camera.width, camera.height,
        cfg.near_plane, cfg.far_plane, (tile_w, tile_h),
        boundary_tiles_v=cfg.cull_pad_v_tiles)
    num_tiles = (camera.width // tile_w) * (camera.height // tile_h)
    dbits = tiling._depth_bits(num_tiles)
    dkey = torch.clamp((raw.depth * cfg.depth_to_sort_key_scale).to(torch.int32),
                       0, (1 << dbits) - 1)
    dkey = torch.where(visible, dkey, torch.full_like(dkey, 2 ** 31 - 1))
    order = torch.sort(dkey, stable=True).indices

    bbox = tiling.tile_bbox(raw.uv, radius, camera.width, camera.height,
                            (tile_w, tile_h))
    h, w_ = camera.height, camera.width
    dev = xyz.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                            torch.arange(w_, device=dev), indexing="ij")
    pix_tu = torch.div(xs, tile_w, rounding_mode="floor").reshape(-1)[:, None]
    pix_tv = torch.div(ys, tile_h, rounding_mode="floor").reshape(-1)[:, None]
    member = ((pix_tu >= bbox.min_u[order][None, :])
              & (pix_tu < bbox.max_u[order][None, :])
              & (pix_tv >= bbox.min_v[order][None, :])
              & (pix_tv < bbox.max_v[order][None, :])
              & visible[order][None, :])
    pixel_xy = torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5],
                           dim=-1).float()

    def fin(x):  # the pre-kernel attribute sanitize of build_keys
        return torch.where(torch.isfinite(x), x, torch.zeros_like(x))

    rgb, depth, alpha, count, _ = blend_dense(
        pixel_xy, member, fin(raw.uv[order]), fin(raw.conic[order]),
        fin(raw.opacity[order]), fin(raw.color[order]), fin(raw.depth[order]))
    return (rgb.reshape(h, w_, 3), depth.reshape(h, w_), alpha.reshape(h, w_),
            count.reshape(h, w_))
