"""Scene-as-GMM Fourier analysis, in torch on the scene's device.

Port of ``taichi_3d_gaussian_splatting_tpu/tools/ftgmm.py``. Pipeline
(``ft_grab_scene``): scene -> Gaussian mixture (means = xyz, covariance
R S S^T R^T, weights = sigmoid(alpha)) -> its probability on a
grid_size^3 lattice over the means' mean +- 3 sigma box -> 3D FFT of that
volume against the mixture's closed-form Fourier transform -> diagnostic
PNGs under ``vis_dir``.

Both evaluations stream over chunks of components (and the transform over
chunks of frequencies too), so memory stays bounded at any number of
points: the log-probability is a logsumexp per component chunk, combined
with a final logsumexp. Log-probabilities come from (R, S) directly, so no
covariance is factored. Matrix products run in full f32 (TF32 off).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    pin_f32_matmul,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    quaternion_to_rotation_matrix,
)

LOG_2PI = float(np.log(2.0 * np.pi))


class SceneGMM(NamedTuple):
    means: torch.Tensor        # (N, 3)
    rot: torch.Tensor          # (N, 3, 3)
    scales: torch.Tensor       # (N, 3) exp(log_scale), clamped
    log_weights: torch.Tensor  # (N,) normalized


def scene_to_gmm(scene: GaussianScene, min_scale: float = 1e-5,
                 max_components: int | None = None,
                 seed: int = 0) -> SceneGMM:
    """The valid points as a mixture. The whole mixture by default;
    ``max_components`` takes a seeded uniform subsample instead."""
    valid = ~scene.invalid
    xyz = scene.xyz[valid]
    feats = scene.features[valid]
    if max_components is not None and xyz.shape[0] > max_components:
        sel = np.random.default_rng(seed).choice(
            xyz.shape[0], max_components, replace=False)
        sel = torch.from_numpy(sel).to(xyz.device)
        xyz, feats = xyz[sel], feats[sel]
    q = feats[:, 0:4]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    rot = quaternion_to_rotation_matrix(q)
    scales = torch.clamp_min(torch.exp(feats[:, 4:7]), min_scale)
    alphas = torch.sigmoid(feats[:, 7])
    log_weights = torch.log(alphas) - torch.log(torch.sum(alphas))
    return SceneGMM(means=xyz, rot=rot, scales=scales,
                    log_weights=log_weights)


def gmm_covariances(gmm: SceneGMM) -> torch.Tensor:
    m = gmm.rot * gmm.scales[:, None, :]
    return m @ m.transpose(-1, -2)


def gmm_log_prob(gmm: SceneGMM, coords: torch.Tensor,
                 comp_chunk: int = 4096) -> torch.Tensor:
    """log p(x) for coords (..., 3): a logsumexp over components, taken
    per chunk of ``comp_chunk`` components (a dense (points, N, 3)
    intermediate does not fit once N reaches the hundreds of thousands)
    and combined exactly by a last logsumexp. The Mahalanobis distance is
    |S^-1 R^T (x - mu)|^2."""
    flat = coords.reshape(-1, 3)
    partial = []
    for c0 in range(0, gmm.means.shape[0], comp_chunk):
        mu = gmm.means[c0:c0 + comp_chunk]
        r = gmm.rot[c0:c0 + comp_chunk]
        s = gmm.scales[c0:c0 + comp_chunk]
        diff = flat[:, None, :] - mu[None, :, :]               # (P, C, 3)
        local = torch.einsum("nij,pni->pnj", r, diff)           # R^T (x - mu)
        y = local / s[None, :, :]
        maha = torch.sum(y * y, dim=-1)                         # (P, C)
        log_det = 2.0 * torch.sum(torch.log(s), dim=-1)         # (C,)
        log_comp = -0.5 * (maha + log_det + 3.0 * LOG_2PI)
        partial.append(torch.logsumexp(
            log_comp + gmm.log_weights[c0:c0 + comp_chunk][None, :], dim=-1))
    lp = torch.logsumexp(torch.stack(partial), dim=0)
    return lp.reshape(coords.shape[:-1])


def estimate_bbox(gmm: SceneGMM) -> Tuple[np.ndarray, np.ndarray]:
    """Mean +- 3 sigma of the means, per axis (host numpy)."""
    means = gmm.means.detach().cpu().numpy()
    mu = means.mean(axis=0)
    std = means.std(axis=0)
    return mu - 3.0 * std, mu + 3.0 * std


def sample_volume(gmm: SceneGMM, grid_size: int = 35, chunk_size: int = 1
                  ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """The mixture's probability on the bbox lattice, ``chunk_size`` grid
    slices at a time. Returns (volume, bbox_min, bbox_max)."""
    bbox_min, bbox_max = estimate_bbox(gmm)
    axes = [np.linspace(bbox_min[i], bbox_max[i], grid_size)
            for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    coords = torch.from_numpy(
        np.stack([gx, gy, gz], axis=-1).astype(np.float32)).to(
            gmm.means.device)
    slices = [gmm_log_prob(gmm, coords[i:i + chunk_size])
              for i in range(0, grid_size, chunk_size)]
    return torch.exp(torch.cat(slices, dim=0)), bbox_min, bbox_max


def volume_to_fourier(volume: torch.Tensor) -> torch.Tensor:
    """Normalized volume -> its centred DFT."""
    v = volume / torch.sum(volume)
    return torch.fft.fftshift(torch.fft.fftn(v))


def fourier_coords(grid_size: int, bbox_min: np.ndarray,
                   bbox_max: np.ndarray) -> np.ndarray:
    """The angular-frequency lattice of the shifted DFT."""
    L = bbox_max - bbox_min
    freqs = [np.fft.fftfreq(grid_size, d=L[i] / grid_size) * 2.0 * np.pi
             for i in range(3)]
    kx, ky, kz = np.meshgrid(*freqs, indexing="ij")
    k = np.stack([kx, ky, kz], axis=-1)
    return np.fft.fftshift(k, axes=(0, 1, 2))


def gmm_fourier(gmm: SceneGMM, k: torch.Tensor, bbox_min, bbox_max,
                freq_chunk: int = 1024,
                comp_chunk: int = 8192) -> torch.Tensor:
    """The mixture's closed-form Fourier transform at angular frequencies
    k (..., 3): F(k) = sum_i w_i exp(-i k.(mu_i - c) - k^T Sigma_i k / 2),
    c the bbox centre. Frequencies and components both go in chunks, and
    the partial sums over component chunks add up exactly."""
    dev = gmm.means.device
    center = torch.as_tensor((bbox_min + bbox_max) / 2.0,
                             dtype=torch.float32, device=dev)
    flat = k.reshape(-1, 3).to(torch.float32)
    shifted = gmm.means - center
    w = torch.exp(gmm.log_weights)
    out = []
    for f0 in range(0, flat.shape[0], freq_chunk):
        fk = flat[f0:f0 + freq_chunk]
        acc = torch.zeros(fk.shape[0], dtype=torch.complex64, device=dev)
        for c0 in range(0, shifted.shape[0], comp_chunk):
            mu = shifted[c0:c0 + comp_chunk]
            r = gmm.rot[c0:c0 + comp_chunk]
            s = gmm.scales[c0:c0 + comp_chunk]
            phase = fk @ mu.T                                   # (F, C)
            kr = torch.einsum("kd,ndi->kni", fk, r)             # k^T R
            quad = torch.sum((kr * s[None]) ** 2, dim=-1)
            mag = w[c0:c0 + comp_chunk][None, :] * torch.exp(-0.5 * quad)
            acc = acc + torch.sum(torch.polar(mag, -phase), dim=-1)
        out.append(acc)
    return torch.cat(out).reshape(k.shape[:-1])


def compare_fft_vs_closed_form(gmm: SceneGMM, volume, bbox_min, bbox_max):
    """The DFT of the sampled volume against the closed form: (metrics,
    dft, analytic), the two as host numpy complex arrays."""
    grid_size = volume.shape[0]
    dft = volume_to_fourier(volume)
    k = torch.from_numpy(fourier_coords(grid_size, bbox_min, bbox_max)).to(
        volume.device)
    analytic = gmm_fourier(gmm, k, bbox_min, bbox_max)
    mag_err = torch.abs(torch.abs(dft) - torch.abs(analytic))
    dft_np = dft.cpu().numpy()
    analytic_np = analytic.cpu().numpy()
    mid = grid_size // 2
    return {
        "mag_err_mean": float(torch.mean(mag_err)),
        "mag_err_max": float(torch.max(mag_err)),
        "dc_dft": complex(dft_np[mid, mid, mid]),
        "dc_analytic": complex(analytic_np[mid, mid, mid]),
    }, dft_np, analytic_np


@torch.no_grad()
def ft_grab_scene(scene: GaussianScene, grid_size: int = 35,
                  vis_dir: str = "vis", plot: bool = True) -> dict:
    """The analysis of one scene, on the scene's device: its metrics, and
    with ``plot`` the diagnostic PNGs (the training loop calls it every
    1234 iterations)."""
    pin_f32_matmul()
    gmm = scene_to_gmm(scene)
    volume, bbox_min, bbox_max = sample_volume(gmm, grid_size=grid_size)
    metrics, dft, analytic = compare_fft_vs_closed_form(
        gmm, volume, bbox_min, bbox_max)
    if plot:
        _plot_diagnostics(volume.cpu().numpy(), dft, analytic, vis_dir)
    return metrics


def _plot_diagnostics(volume, dft, analytic, vis_dir: str) -> None:
    """Centre-slice PNGs of the log volume and of both spectra; nothing
    when matplotlib is missing."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    os.makedirs(vis_dir, exist_ok=True)
    mid = volume.shape[0] // 2
    vol = np.log(np.maximum(np.asarray(volume), 1e-30))
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(vol[mid, :, :]); axes[0].set_title("YZ slice (center X)")
    axes[1].imshow(vol[:, mid, :]); axes[1].set_title("XZ slice (center Y)")
    axes[2].imshow(vol[:, :, mid]); axes[2].set_title("XY slice (center Z)")
    fig.tight_layout()
    fig.savefig(os.path.join(vis_dir, "grid_gt.png"))
    plt.close(fig)

    fig, axes = plt.subplots(2, 3, figsize=(15, 10))
    for row, vol_c in enumerate((np.asarray(dft), np.asarray(analytic))):
        name = "DFT" if row == 0 else "analytic"
        axes[row, 0].imshow(np.abs(vol_c[mid, :, :]))
        axes[row, 0].set_title(f"{name} magnitude (YZ)")
        axes[row, 1].imshow(np.abs(vol_c[:, mid, :]))
        axes[row, 1].set_title(f"{name} magnitude (XZ)")
        axes[row, 2].imshow(np.angle(vol_c[:, :, mid]))
        axes[row, 2].set_title(f"{name} phase (XY)")
    fig.tight_layout()
    fig.savefig(os.path.join(vis_dir, "volume_fourier_spectrum.png"))
    plt.close(fig)
