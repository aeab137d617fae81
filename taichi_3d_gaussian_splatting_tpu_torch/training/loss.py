"""Training loss: (1-lambda) L1 + lambda (1 - SSIM) + optional scale reg.

Port of ``taichi_3d_gaussian_splatting_tpu/training/loss.py``: SSIM with
the standard constants (11-tap Gaussian window, sigma 1.5, data range 1,
k1 0.01, k2 0.03) over a 'valid' separable blur, here two depthwise
``conv2d`` passes. The blur's variance estimate blur(x^2) - mu^2 cancels
almost completely in flat regions, so it runs in full f32: call
``rasterizer.pin_f32_matmul`` (no TF32 in cuDNN) before it on a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_value: float = 0.2
    enable_regularization: bool = True
    regularization_weight: float = 2.0


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def host_constant(array: np.ndarray, device) -> torch.Tensor:
    """A host-made constant as a tensor on ``device``. To a card it goes
    from pinned memory without a host sync, so a constant first needed in
    a window's warm-up (run under the sync-debug mode "error" before the
    capture) does not stop it."""
    t = torch.from_numpy(array)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_WINDOWS: dict = {}


def _window_on(device, size: int, sigma: float) -> torch.Tensor:
    """The window as a tensor on ``device``, copied there once: a CUDA
    graph of the train step cannot capture a host-to-device copy."""
    key = (str(device), size, sigma)
    win = _WINDOWS.get(key)
    if win is None:
        win = _WINDOWS[key] = host_constant(_gaussian_window(size, sigma),
                                            device)
    return win


def _blur(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' Gaussian blur of an (H, W, C) image: (H-k+1,
    W-k+1, C)."""
    c = img.shape[-1]
    k = win.shape[0]
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(c, 1, k, 1), groups=c)
    x = F.conv2d(x, win.reshape(1, 1, 1, k).expand(c, 1, 1, k), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    if img1.shape[0] < win_size or img1.shape[1] < win_size:
        raise ValueError(
            f"SSIM needs images >= {win_size}px per side, got "
            f"{img1.shape[0]}x{img1.shape[1]}")
    win = _window_on(img1.device, win_size, win_sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _blur(img1 * img1, win) - mu1_sq
    sigma2_sq = _blur(img2 * img2, win) - mu2_sq
    sigma12 = _blur(img1 * img2, win) - mu1_mu2
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return torch.mean(ssim_map)


def compute_loss(predicted: torch.Tensor, target: torch.Tensor,
                 cfg: LossConfig, features: torch.Tensor | None = None,
                 invalid_mask: torch.Tensor | None = None):
    """Returns (loss, l1, ssim_value) for (H, W, 3) images; with
    ``features`` (N, 56) adds the mean L2 norm of exp(log scale) over the
    valid points."""
    d = predicted - target
    # |d| with the subgradient 1 at d == 0, as JAX differentiates abs
    # (torch.abs takes 0 there)
    l1 = torch.mean(torch.where(d >= 0, d, -d))
    ssim_val = ssim(predicted, target)
    loss = (1.0 - cfg.lambda_value) * l1 + cfg.lambda_value * (1.0 - ssim_val)
    if cfg.enable_regularization and features is not None:
        logs = features[:, 4:7]
        if invalid_mask is not None:
            # mask the INPUT log-scales: an overflowing exp on an invalid
            # row would otherwise give inf/inf = NaN in the gradient
            valid = ~invalid_mask
            logs = torch.where(valid[:, None], logs, torch.zeros_like(logs))
            norms = torch.linalg.vector_norm(torch.exp(logs), dim=-1)
            reg = (torch.sum(torch.where(valid, norms, torch.zeros_like(norms)))
                   / torch.clamp_min(torch.sum(valid), 1))
        else:
            reg = torch.mean(torch.linalg.vector_norm(torch.exp(logs), dim=-1))
        loss = loss + cfg.regularization_weight * reg
    return loss, l1, ssim_val


def psnr(predicted: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR in dB, data range 1.0."""
    mse = torch.mean((predicted - target) ** 2)
    return 10.0 * torch.log10(1.0 / torch.clamp_min(mse, 1e-12))
