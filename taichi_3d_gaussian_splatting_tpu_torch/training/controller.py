"""Adaptive density controller: densify / split / prune over the fixed
pool.

Port of ``taichi_3d_gaussian_splatting_tpu/training/controller.py``:

- ``accumulate``: the per-point statistics of each frame;
- ``find_densify``: the selection, as dense masks over the pool;
- ``apply_densify``: the r-th densify source (pool order) lands in the r-th
  invalid slot (pool order), found by two stable sorts, with no host sync;
  the pool's capacity never changes;
- ``reset_alpha``.

JAX's ``jax.random`` streams cannot be drawn in torch, so ``apply_densify``
draws its two (N, 3) normal tensors from a ``torch.Generator`` and hands
them to ``apply_densify_with_noise``, which the tests feed JAX's draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    quaternion_to_rotation_matrix,
)


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    num_iterations_warm_up: int = 500
    num_iterations_densify: int = 100
    transparent_alpha_threshold: float = -0.5
    densification_view_space_position_gradients_threshold: float = 6e-6
    densification_view_avg_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_view_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_view_pixel_avg_space_position_gradients_threshold: float = 1e3
    densification_multi_frame_position_gradients_threshold: float = 1e3
    gaussian_split_factor_phi: float = 1.6
    num_iterations_reset_alpha: int = 3000
    reset_alpha_value: float = 0.1
    floater_num_pixels_threshold: int = 10000
    floater_near_camrea_num_pixels_threshold: int = 10000
    floater_depth_threshold: float = 100.0
    iteration_start_remove_floater: int = 2000
    plot_densify_interval: int = 200
    under_reconstructed_num_pixels_threshold: int = 512
    under_reconstructed_move_factor: float = 100.0
    enable_ellipsoid_offset: bool = False
    enable_sample_from_point: bool = True


class ControllerState(NamedTuple):
    """Per-point accumulators across frames."""

    num_pixels: torch.Tensor          # (N,) f32 affected-pixel count sum
    num_in_camera: torch.Tensor       # (N,) f32 frames-visible count
    grad_viewspace: torch.Tensor      # (N,) f32 sum of |grad_uv|
    grad_viewspace_avg: torch.Tensor  # (N,) f32 sum of per-pixel-avg |grad_uv|
    grad_position: torch.Tensor       # (N, 3) f32 sum of xyz grads
    grad_position_norm: torch.Tensor  # (N,) f32 sum of |xyz grad|


def init_state(capacity: int, device="cuda") -> ControllerState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return ControllerState(
        num_pixels=z(capacity), num_in_camera=z(capacity),
        grad_viewspace=z(capacity), grad_viewspace_avg=z(capacity),
        grad_position=z(capacity, 3), grad_position_norm=z(capacity))


def accumulate(state: ControllerState, in_camera: torch.Tensor,
               num_affected_pixels: torch.Tensor,
               magnitude_grad_viewspace: torch.Tensor,
               grad_xyz: torch.Tensor) -> ControllerState:
    """Add one frame's statistics of the visible points."""
    vis = in_camera.to(torch.float32)
    avg = magnitude_grad_viewspace / num_affected_pixels
    # x/0 and 0/0 for points no pixel included: zero every non-finite value
    avg = torch.where(torch.isfinite(avg), avg, torch.zeros_like(avg))
    return ControllerState(
        num_pixels=state.num_pixels + vis * num_affected_pixels,
        num_in_camera=state.num_in_camera + vis,
        grad_viewspace=state.grad_viewspace + vis * magnitude_grad_viewspace,
        grad_viewspace_avg=state.grad_viewspace_avg + vis * avg,
        grad_position=state.grad_position + vis[:, None] * grad_xyz,
        grad_position_norm=state.grad_position_norm
        + vis * torch.linalg.vector_norm(grad_xyz, dim=-1),
    )


class DensifyInfo(NamedTuple):
    """The selection of one densify round, as dense masks over the pool."""

    remove_mask: torch.Tensor       # (N,) bool: floater | transparent
    densify_mask: torch.Tensor      # (N,) bool
    position_before: torch.Tensor   # (N, 3) xyz when selected
    size_reduction: torch.Tensor    # (N,) log(phi) where split else 0
    grad_position: torch.Tensor     # (N, 3) averaged accumulated xyz grad
    over_mask: torch.Tensor         # (N,) bool: split (vs clone)


def _nan_to_zero(x: torch.Tensor) -> torch.Tensor:
    """NaN -> 0; +-inf stay, as the JAX package's ``_nan_to_zero``."""
    return torch.where(torch.isnan(x), torch.zeros_like(x), x)


def find_densify(scene: GaussianScene, state: ControllerState,
                 in_camera: torch.Tensor, num_affected_pixels: torch.Tensor,
                 magnitude_grad_viewspace: torch.Tensor,
                 point_depth: torch.Tensor, remove_floaters: bool,
                 cfg: ControllerConfig) -> DensifyInfo:
    """Selection pass on the post-optimizer-step scene: floaters (after
    warm-in) and transparent or NaN points are removed; points whose
    single-frame or multi-frame gradients pass a threshold densify, split
    when their accumulated pixel footprint is large, else cloned."""
    valid = ~scene.invalid

    floater = in_camera & (
        (num_affected_pixels > cfg.floater_near_camrea_num_pixels_threshold)
        & (point_depth < cfg.floater_depth_threshold))
    if not remove_floaters:
        floater = torch.zeros_like(floater)
    floater = floater & valid

    alpha = scene.features[:, 7]
    nan_mask = torch.isnan(scene.features).any(dim=-1)
    transparent = ((alpha < cfg.transparent_alpha_threshold) | nan_mask) & (
        valid & ~floater)
    remove_mask = floater | transparent

    single = in_camera & (
        magnitude_grad_viewspace
        > cfg.densification_view_space_position_gradients_threshold)
    per_pixel = _nan_to_zero(magnitude_grad_viewspace / num_affected_pixels)
    single = single | (in_camera & (
        per_pixel
        > cfg.densification_view_avg_space_position_gradients_threshold))

    mf_view = _nan_to_zero(state.grad_viewspace / state.num_in_camera)
    multi = mf_view > (
        cfg.densification_multi_frame_view_space_position_gradients_threshold)
    avg_pixels = _nan_to_zero(state.num_pixels / state.num_in_camera)
    mf_view_avg = _nan_to_zero(state.grad_viewspace_avg / state.num_in_camera)
    multi = multi | (
        mf_view_avg / torch.clamp_min(avg_pixels, 1e-12)
        > cfg.densification_multi_frame_view_pixel_avg_space_position_gradients_threshold)
    mf_pos = _nan_to_zero(state.grad_position_norm / state.num_in_camera)
    multi = multi | (
        mf_pos > cfg.densification_multi_frame_position_gradients_threshold)

    densify = (single | multi) & valid & ~remove_mask
    over = densify & (
        state.num_pixels > cfg.under_reconstructed_num_pixels_threshold)
    log_phi = torch.log(torch.tensor(cfg.gaussian_split_factor_phi,
                                     dtype=torch.float32))
    size_reduction = torch.where(over, log_phi.to(over.device),
                                 torch.zeros((), device=over.device))
    grad_pos = _nan_to_zero(state.grad_position / torch.clamp_min(
        state.num_in_camera[:, None], 1.0))
    return DensifyInfo(remove_mask=remove_mask, densify_mask=densify,
                       position_before=scene.xyz,
                       size_reduction=size_reduction,
                       grad_position=grad_pos, over_mask=over)


def _rotation_and_scale(features: torch.Tensor):
    q = features[:, 0:4]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return quaternion_to_rotation_matrix(q), torch.exp(features[:, 4:7])


def _sample_from_gaussian(eps: torch.Tensor, xyz: torch.Tensor,
                          features: torch.Tensor) -> torch.Tensor:
    """xyz + R (eps * s): a sample of each point's own Gaussian, from the
    (N, 3) standard normal draws ``eps``."""
    r, s = _rotation_and_scale(features)
    return xyz + (r * (eps * s)[:, None, :]).sum(dim=-1)


def _ellipsoid_foci_offset(features: torch.Tensor) -> torch.Tensor:
    """Centre -> focus vector of the ellipsoid: along the major axis, of
    length sqrt(a^2 - b^2), a the largest and b the smallest semi-axis."""
    r, s = _rotation_and_scale(features)
    major = torch.argmax(s, dim=-1)
    a = torch.amax(s, dim=-1)
    b = torch.amin(s, dim=-1)
    c = torch.sqrt(torch.clamp_min(a * a - b * b, 0.0))
    axis = torch.gather(r, 2, major[:, None, None].expand(-1, 3, 1))[..., 0]
    return axis * c[:, None]


def _scatter_rows(dst: torch.Tensor, index: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``dst`` with dst[index[r]] = rows[r]; index == len(dst)
    drops row r (JAX's ``.at[index].set(rows, mode="drop")``; the kept
    indices are distinct)."""
    n = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])  # a spare row takes the dropped ones
    ext.index_copy_(0, index, rows)
    return ext[:n]


def apply_densify_with_noise(scene: GaussianScene, info: DensifyInfo,
                             eps_new: torch.Tensor, eps_src: torch.Tensor,
                             cfg: ControllerConfig) -> GaussianScene:
    """The mutation pass with its standard normal draws given: ``eps_new``
    (N, 3) samples the new points (the JAX package's key k1, one row a
    rank), ``eps_src`` (N, 3) resamples the split sources (k2, one row a
    slot)."""
    n = scene.capacity
    dev = scene.xyz.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    invalid_after = scene.invalid | info.remove_mask

    # the r-th invalid slot and the r-th densify source, in pool order
    dst = torch.sort(torch.where(invalid_after, idx, n + idx),
                     stable=True).indices
    src = torch.sort(torch.where(info.densify_mask, idx, n + idx),
                     stable=True).indices
    num_fill = torch.minimum(info.densify_mask.sum(), invalid_after.sum())
    active = idx < num_fill

    new_xyz = info.position_before[src]
    new_feat = scene.features[src]
    new_feat[:, 4:7] -= info.size_reduction[src][:, None]
    new_oid = scene.object_id[src]
    over = info.over_mask[src]
    # foci offset first, then split points are overwritten by a sample and
    # clones move along their accumulated gradient
    if cfg.enable_ellipsoid_offset:
        new_xyz = new_xyz + _ellipsoid_foci_offset(new_feat)
    if cfg.enable_sample_from_point:
        sampled_new = _sample_from_gaussian(eps_new, new_xyz, new_feat)
    else:
        sampled_new = new_xyz
    new_xyz = torch.where(
        over[:, None], sampled_new,
        new_xyz + info.grad_position[src] * cfg.under_reconstructed_move_factor)

    dst_masked = torch.where(active, dst, torch.full_like(dst, n))
    xyz = _scatter_rows(scene.xyz, dst_masked, new_xyz)
    features = _scatter_rows(scene.features, dst_masked, new_feat)
    object_id = _scatter_rows(scene.object_id, dst_masked, new_oid)
    invalid = _scatter_rows(invalid_after, dst_masked,
                            torch.zeros_like(invalid_after))

    # shrink the split sources too, and resample their positions
    src_masked = torch.where(active, src, torch.full_like(src, n))
    filled_src = _scatter_rows(torch.zeros_like(invalid_after), src_masked,
                               torch.ones_like(invalid_after))
    shrink = torch.where(filled_src, info.size_reduction,
                         torch.zeros_like(info.size_reduction))
    features[:, 4:7] -= shrink[:, None]
    if cfg.enable_ellipsoid_offset:
        off_all = _ellipsoid_foci_offset(features)
        xyz = torch.where(filled_src[:, None], xyz - off_all, xyz)
    if cfg.enable_sample_from_point:
        resampled = _sample_from_gaussian(eps_src, xyz, features)
        xyz = torch.where((filled_src & info.over_mask)[:, None], resampled,
                          xyz)
    return GaussianScene(xyz=xyz, features=features, invalid=invalid,
                         object_id=object_id)


def apply_densify(scene: GaussianScene, info: DensifyInfo,
                  generator: torch.Generator,
                  cfg: ControllerConfig) -> GaussianScene:
    """The mutation pass, its normal draws taken from ``generator`` (on the
    scene's device): first the new points', then the split sources'."""
    shape = tuple(scene.xyz.shape)
    draw = lambda: torch.randn(shape, generator=generator,  # noqa: E731
                               dtype=torch.float32, device=scene.xyz.device)
    eps_new = draw()
    eps_src = draw()
    return apply_densify_with_noise(scene, info, eps_new, eps_src, cfg)


def reset_alpha(scene: GaussianScene, cfg: ControllerConfig) -> GaussianScene:
    """Clamp alpha logits down to ``reset_alpha_value`` (NaN stays)."""
    features = scene.features.clone()
    features[:, 7] = torch.minimum(
        features[:, 7], torch.tensor(cfg.reset_alpha_value,
                                     dtype=torch.float32,
                                     device=features.device))
    return scene._replace(features=features)
