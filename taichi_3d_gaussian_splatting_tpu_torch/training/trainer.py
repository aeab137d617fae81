"""One training step: forward, loss, backward, Adam, densify accumulators.

Port of ``make_train_step`` of ``taichi_3d_gaussian_splatting_tpu/training/
trainer.py`` (without pose refinement and without ``scan_steps``). The step
runs forward (``rasterize_fwd_ctx``: attributes, tile keys, the blend
kernel), the L1 + SSIM loss, the backward (``rasterize_bwd``: the
blend_backward kernel, the segment_reduce kernel reading its sorted rows
through the inverse key permutation, autograd of the attributes), the
grad factors, one Adam on the
features and one on the positions (staircase-decayed learning rate), and
``controller.accumulate``. It returns a new state and leaves its input as
it was.

Adam is optax's: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected,
the update added as ``p - lr * mu_hat / (sqrt(nu_hat) + eps)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    RasterizerConfig,
    rasterize_bwd,
    rasterize_fwd_ctx,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as ctrl
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
    compute_loss,
    psnr as psnr_fn,
)


def grad_factor_vector(cfg: RasterizerConfig) -> np.ndarray:
    """Per-column feature-gradient scaling."""
    f = np.ones((56,), np.float32)
    f[0:4] = cfg.grad_q_factor
    f[4:7] = cfg.grad_s_factor
    f[7] = cfg.grad_alpha_factor
    f[8:] = cfg.grad_high_order_color_factor
    f[[8, 24, 40]] = cfg.grad_color_factor
    return f


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int  # updates applied so far (optax's count)


class TrainState(NamedTuple):
    scene: GaussianScene
    feat_opt: AdamState
    pos_opt: AdamState
    ctrl: ctrl.ControllerState


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax.adam with a learning rate that is a function of the count of
    updates before this one."""

    lr: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, param: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros_like(param), torch.zeros_like(param), 0)

    def update(self, grad: torch.Tensor, state: AdamState,
               param: torch.Tensor):
        """Returns (new param, new state)."""
        count = state.count + 1
        mu = (1.0 - self.b1) * grad + self.b1 * state.mu
        nu = (1.0 - self.b2) * (grad * grad) + self.b2 * state.nu
        # 1 - b**count in f32, as optax computes it
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        new_param = param + (-self.lr(state.count)) * u
        return new_param, AdamState(mu, nu, count)


def make_optimizers(config: TrainConfig):
    """(feature Adam, position Adam); the position learning rate decays by
    ``position_learning_rate_decay_rate`` every ``..._decay_interval``
    updates (optax.exponential_decay with staircase=True)."""
    lr_f = config.feature_learning_rate
    lr0 = config.position_learning_rate
    rate = config.position_learning_rate_decay_rate
    interval = config.position_learning_rate_decay_interval

    def position_lr(count: int) -> float:
        return lr0 * rate ** (count // interval)

    return Adam(lambda count: lr_f), Adam(position_lr)


def init_train_state(scene: GaussianScene, config: TrainConfig) -> TrainState:
    feature_tx, position_tx = make_optimizers(config)
    return TrainState(
        scene=scene, feat_opt=feature_tx.init(scene.features),
        pos_opt=position_tx.init(scene.xyz),
        ctrl=ctrl.init_state(scene.capacity, device=scene.xyz.device))


def make_train_step(config: TrainConfig, height: int, width: int,
                    scan_steps: int = 0, device="cuda"):
    """The step for one (height, width) image size, on ``device``:
    ``step(state, image_gt, q, t, K, sh_band) -> (new_state, metrics,
    aux)``, with the (H, W, 3) ground truth in uint8 or f32 and the camera
    pose (q, t) in the world frame."""
    if scan_steps > 0:
        raise NotImplementedError(
            "scan_steps: the JAX package's lax.scan windows only saved "
            "remote-TPU dispatches; the port runs one step per call and "
            "does not port them (ROADMAP.md)")
    if config.pose_refinement:
        raise NotImplementedError(
            "pose_refinement is not ported yet; it comes with the poses "
            "slice (ROADMAP.md A8)")
    rcfg = config.rasterisation_config
    if config.train_slim and not rcfg.rgb_only:
        # blend rgb only; gradients and densify stats are unchanged
        rcfg = dataclasses.replace(rcfg, slim=True)
    lcfg = config.loss_function_config
    feature_tx, position_tx = make_optimizers(config)
    dev = torch.device(device)
    gf = torch.from_numpy(grad_factor_vector(rcfg)).to(dev)

    def step(state: TrainState, image_gt, q, t, K, sh_band):
        scene = state.scene
        if scene.xyz.device.type != dev.type:
            raise ValueError(f"the step was made for {dev}, the state lies "
                             f"on {scene.xyz.device}")
        if image_gt.dtype == torch.uint8:
            image_gt = image_gt.to(torch.float32) * (1.0 / 255.0)
        camera = Camera(K=K, width=width, height=height)
        out, ctx, attrs_vjp = rasterize_fwd_ctx(
            scene.xyz, scene.features, scene.invalid, q, t, camera, rcfg,
            sh_max_band=sh_band, point_object_id=scene.object_id)
        pred = torch.clamp(out.rgb, 0.0, 1.0)

        p = pred.detach().requires_grad_(True)
        f = scene.features.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, l1, ssim_v = compute_loss(p, image_gt, lcfg, features=f,
                                            invalid_mask=scene.invalid)
            d_pred, d_feat_reg = torch.autograd.grad(loss, (p, f),
                                                     allow_unused=True)
        if d_feat_reg is None:  # no regularizer
            d_feat_reg = torch.zeros_like(scene.features)

        with torch.no_grad():
            # the clamp's backward: zero where it was active, and at the
            # bounds (empty pixels sit at exactly 0)
            pass_mask = (out.rgb > 0.0) & (out.rgb < 1.0)
            d_rgb = torch.where(pass_mask, d_pred, torch.zeros_like(d_pred))
        (d_xyz, d_features), stats = rasterize_bwd(ctx, attrs_vjp, d_rgb,
                                                   camera, rcfg)
        with torch.no_grad():
            d_features = d_features * gf[None, :] + d_feat_reg
            # never move invalid slots
            valid = ~scene.invalid[:, None]
            d_xyz = torch.where(valid, d_xyz, torch.zeros_like(d_xyz))
            d_features = torch.where(valid, d_features,
                                     torch.zeros_like(d_features))
            features, feat_opt = feature_tx.update(
                d_features, state.feat_opt, scene.features)
            xyz, pos_opt = position_tx.update(d_xyz, state.pos_opt, scene.xyz)
            ctrl_state = ctrl.accumulate(
                state.ctrl, stats.in_camera, stats.num_affected_pixels,
                stats.magnitude_grad_viewspace, d_xyz)
            metrics = {
                "loss": loss.detach(), "l1": l1.detach(),
                "ssim": ssim_v.detach(), "psnr": psnr_fn(pred, image_gt),
                "num_keys": ctx.keys.total,
            }
        aux = {
            "pred": pred, "stats": stats, "point_depth": ctx.raw.depth,
            "point_uv": ctx.raw.uv, "grad_features": d_features,
            "grad_xyz": d_xyz,
        }
        new_state = TrainState(
            scene=scene._replace(features=features, xyz=xyz),
            feat_opt=feat_opt, pos_opt=pos_opt, ctrl=ctrl_state)
        return new_state, metrics, aux

    return step
