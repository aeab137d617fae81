"""Adaptive density controller: the per-point accumulators.

Port of ``ControllerConfig``, ``ControllerState``, ``init_state`` and
``accumulate`` of ``taichi_3d_gaussian_splatting_tpu/training/
controller.py``. ``find_densify``, ``apply_densify`` and ``reset_alpha``
come with the training loop (ROADMAP.md A6).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


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
