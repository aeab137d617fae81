"""Plain reference of one train step: the render of ``splat.py``, the
L1 + SSIM loss, the gradients of positions and features through the blend
and the attributes, the per-column gradient factors, and Adam on the
features and on the positions (optax's update: bias-corrected moments,
a staircase-decayed position learning rate); and the data-parallel step's
mean of a batch's gradients (``mean_step``).

Only the rgb image backpropagates, through the clamp to [0, 1] (no
gradient where the clamp holds or at its bounds); the 0.99 alpha clamp is
straight-through. Nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import splat


def _window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """'valid' separable blur of an (H, W, C) image."""
    c, k = img.shape[-1], win.shape[0]
    x = img.permute(2, 0, 1)[None]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM (11-tap Gaussian window, sigma 1.5, k1 0.01, k2 0.03,
    data range 1) of two (H, W, C) images."""
    win = torch.from_numpy(_window()).to(a.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(a, win), _blur(b, win)
    s11 = _blur(a * a, win) - mu1 * mu1
    s22 = _blur(b * b, win) - mu2 * mu2
    s12 = _blur(a * b, win) - mu1 * mu2
    cs = (2.0 * s12 + c2) / (s11 + s22 + c2)
    return torch.mean(((2.0 * mu1 * mu2 + c1)
                       / (mu1 * mu1 + mu2 * mu2 + c1)) * cs)


def loss_fn(pred: torch.Tensor, target: torch.Tensor, lam: float):
    """(1 - lam) L1 + lam (1 - SSIM); |d| has the subgradient 1 at 0."""
    d = pred - target
    l1 = torch.mean(torch.where(d >= 0, d, -d))
    return (1.0 - lam) * l1 + lam * (1.0 - ssim(pred, target))


def grad_factors(cfg: dict, device) -> torch.Tensor:
    """(56,) per-column feature-gradient factors: quaternion, log scale,
    opacity, the DC colours (columns 8, 24, 40), the other SH terms."""
    f = torch.ones(56, dtype=torch.float32)
    f[0:4] = cfg["grad_q_factor"]
    f[4:7] = cfg["grad_s_factor"]
    f[7] = cfg["grad_alpha_factor"]
    f[8:] = cfg["grad_high_order_color_factor"]
    f[[8, 24, 40]] = cfg["grad_color_factor"]
    return f.to(device)


class Moments(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


class State(NamedTuple):
    xyz: torch.Tensor
    feats: torch.Tensor
    feat_opt: Moments
    pos_opt: Moments


def init_state(xyz: torch.Tensor, feats: torch.Tensor) -> State:
    def zero(p):
        return Moments(torch.zeros_like(p), torch.zeros_like(p), 0)
    return State(xyz, feats, zero(feats), zero(xyz))


B1, B2, EPS = 0.9, 0.999, 1e-8


def adam(p: torch.Tensor, g: torch.Tensor, m: Moments, lr: float):
    """optax.adam: (new parameter, new moments); the bias corrections are
    f32 1 - b**count."""
    count = m.count + 1
    mu = (1.0 - B1) * g + B1 * m.mu
    nu = (1.0 - B2) * (g * g) + B2 * m.nu
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
    return p - lr * u, Moments(mu, nu, count)


class StepOut(NamedTuple):
    state: State
    loss: float
    d_xyz: torch.Tensor     # the gradients as the optimizers take them
    d_feats: torch.Tensor
    counts: dict            # the frame's work (``splat.blend``)


def gradients(state: State, target: torch.Tensor, view: splat.View,
              cfg: dict, sh_band: int = 3):
    """(loss, d_xyz, d_feats, counts) of one view on the (H, W, 3) f32
    ``target``: the gradients as the optimizers take them (the features'
    with the per-column factors) and the frame's work (``splat.blend``)."""
    tile = cfg["tile_size"]
    xyz = state.xyz.detach().requires_grad_(True)
    feats = state.feats.detach().requires_grad_(True)
    with torch.enable_grad():
        at = splat.attributes(xyz, feats, view, sh_band)
    keys = splat.tile_keys(at, view, cfg["near_plane"], cfg["far_plane"],
                           cfg["depth_to_sort_key_scale"], tile)
    counts = {}
    rgb = splat.blend(at, keys, tile, counts)
    img = rgb.detach().requires_grad_(True)
    with torch.enable_grad():
        pred = torch.clamp(img, 0.0, 1.0)
        loss = loss_fn(pred, target, cfg["lambda_value"])
        (d_pred,) = torch.autograd.grad(loss, pred)
    d_rgb = torch.where((rgb > 0.0) & (rgb < 1.0), d_pred,
                        torch.zeros_like(d_pred))
    d_at = splat.blend_backward(at, keys, d_rgb, tile)
    d_xyz, d_feats = torch.autograd.grad(
        (at.uv, at.conic, at.ro, at.color), (xyz, feats),
        (d_at.uv, d_at.conic, d_at.ro, d_at.color), allow_unused=True)
    d_xyz = torch.zeros_like(xyz) if d_xyz is None else d_xyz
    d_feats = torch.zeros_like(feats) if d_feats is None else d_feats
    d_feats = d_feats * grad_factors(cfg, feats.device)[None, :]
    return float(loss.detach()), d_xyz, d_feats, counts


def update(state: State, d_xyz: torch.Tensor, d_feats: torch.Tensor,
           cfg: dict) -> State:
    """Both Adams from the step's gradients."""
    with torch.no_grad():
        new_feats, fo = adam(state.feats, d_feats, state.feat_opt,
                             cfg["feature_learning_rate"])
        pos_lr = float(np.float32(
            cfg["position_learning_rate"]
            * cfg["position_learning_rate_decay_rate"]
            ** (state.pos_opt.count
                // cfg["position_learning_rate_decay_interval"])))
        new_xyz, po = adam(state.xyz, d_xyz, state.pos_opt, pos_lr)
    return State(new_xyz, new_feats, fo, po)


def train_step(state: State, target: torch.Tensor, view: splat.View,
               cfg: dict, sh_band: int = 3) -> StepOut:
    """One step on the (H, W, 3) f32 ``target``. ``cfg``: the
    configuration's ``train`` group (near, far, depth scale, tile, loss
    weight, gradient factors, learning rates)."""
    loss, d_xyz, d_feats, counts = gradients(state, target, view, cfg,
                                             sh_band)
    return StepOut(update(state, d_xyz, d_feats, cfg), loss, d_xyz, d_feats,
                   counts)


def mean_step(state: State, targets: list, views: list, cfg: dict,
              sh_band: int = 3) -> StepOut:
    """One data-parallel step over a batch of views: each view's gradients
    as ``gradients`` takes them, summed in the batch's order and divided
    by its size, then Adam; the loss is the batch's mean. ``counts`` are
    the last view's."""
    losses, d_xyz, d_feats = [], None, None
    for target, view in zip(targets, views):
        loss, gx, gf, counts = gradients(state, target, view, cfg, sh_band)
        losses.append(loss)
        d_xyz = gx if d_xyz is None else d_xyz + gx
        d_feats = gf if d_feats is None else d_feats + gf
    d_xyz, d_feats = d_xyz / len(views), d_feats / len(views)
    return StepOut(update(state, d_xyz, d_feats, cfg),
                   float(np.mean(losses)), d_xyz, d_feats, counts)
