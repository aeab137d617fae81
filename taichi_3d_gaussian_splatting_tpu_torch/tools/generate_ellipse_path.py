"""Fly-through pose generation: fit an ellipse around the capture's focus.

Port of
``taichi_3d_gaussian_splatting_tpu/tools/generate_ellipse_path.py``,
a copy that runs on the host alone (no device, no torch but the
``.pt`` save of the ellipse path).

Behavioral reference: tools/generate_ellipse_path.py (a numpy/torch port of
nerfstudio's camera-path utilities). Pipeline (:253-285):
  train.json poses -> OpenGL convention -> auto-orient/center ("up" method)
  -> ellipse positions around the focus point (90th-percentile axes)
  -> look-at view matrices -> transform back -> OpenCV convention
  -> (N, 4, 4) float tensor saved with torch.save for the headless renderer.

This edition is pure numpy (torch only for the .pt save); the "pca" /
"vertical" orientation variants are included for parity (:148-250).
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np



def pose_opencv_to_opengl(c2w: np.ndarray) -> np.ndarray:
    """Involution converting between OpenCV and OpenGL camera axes
    (reference :16-27; double application is the identity)."""
    c2w = c2w.copy()
    c2w[:, 0:3, 1:3] *= -1
    c2w = c2w[:, np.array([1, 0, 2, 3]), :]
    c2w[:, 2, :] *= -1
    return c2w


def normalize(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position) -> np.ndarray:
    """Look-at 3x4 view matrix (reference :34-50)."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def focus_point_fn(poses: np.ndarray) -> np.ndarray:
    """Closest point to all optical axes (reference :52-58)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_ellipse_path(
    poses: np.ndarray, n_frames: int = 120, z_variation: float = 0.0,
    z_phase: float = 0.0,
) -> np.ndarray:
    """Ellipse around the focus point, axes from the 90th percentile of
    camera offsets (reference :61-118)."""
    center = focus_point_fn(poses)
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    theta = np.linspace(0, 2 * np.pi, n_frames + 1, endpoint=True)
    positions = np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2]
                       * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)[:-1]

    avg_up = normalize(poses[:, :3, 1].mean(0))
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])
    return np.stack([viewmatrix(p - center, up, p) for p in positions])


def rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to b (reference :120-145)."""
    a = normalize(a)
    b = normalize(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if c < -1 + 1e-8:
        eps = (np.random.default_rng(0).random(3) - 0.5) * 0.01
        return rotation_between(a + eps, b)
    s = np.linalg.norm(v)
    skew = np.array([
        [0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0],
    ])
    return np.eye(3) + skew + skew @ skew * ((1 - c) / (s**2 + 1e-8))


def auto_orient_and_center_poses(
    poses: np.ndarray, method: str = "up", center_method: str = "poses",
):
    """nerfstudio-style orientation (reference :148-250). Returns
    (oriented (N, 3, 4)..., transform (3, 4))."""
    origins = poses[..., :3, 3]
    mean_origin = origins.mean(axis=0)
    translation_diff = origins - mean_origin

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "none":
        translation = np.zeros_like(mean_origin)
    else:
        raise ValueError(f"unknown center_method {center_method}")

    if method == "pca":
        _, eigvec = np.linalg.eigh(translation_diff.T @ translation_diff)
        eigvec = np.flip(eigvec, axis=-1).copy()
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] = -eigvec[:, 2]
        transform = np.concatenate(
            [eigvec, eigvec @ -translation[..., None]], axis=-1)
        oriented = transform @ poses
        if oriented.mean(axis=0)[2, 1] < 0:
            # the flip is a global left-multiplication by diag(1,-1,-1):
            # it must apply to the returned transform too, or the caller's
            # inverse maps the ellipse back through the unflipped frame
            # (mirrored fly-through)
            oriented[:, 1:3] = -oriented[:, 1:3]
            transform[1:3] = -transform[1:3]
    elif method in ("up", "vertical"):
        up = normalize(poses[:, :3, 1].mean(axis=0))
        if method == "vertical":
            x_axis = poses[:, :3, 0]
            _, S, Vh = np.linalg.svd(x_axis, full_matrices=False)
            if S[1] > 0.17 * math.sqrt(poses.shape[0]):
                up_vertical = Vh[2, :]
                up = up_vertical if np.dot(up_vertical, up) > 0 else -up_vertical
            else:
                up = normalize(up - Vh[0, :] * np.dot(up, Vh[0, :]))
        rotation = rotation_between(up, np.array([0.0, 0.0, 1.0]))
        transform = np.concatenate(
            [rotation, rotation @ -translation[..., None]], axis=-1)
        oriented = transform @ poses
    elif method == "none":
        transform = np.eye(4)[:3]
        transform[:3, 3] = -translation
        oriented = transform @ poses
    else:
        raise ValueError(f"unknown method {method}")
    return oriented, transform


def ellipse_path_from_dataset(cameras_json: list, n_frames: int = 120,
                              method: str = "up") -> np.ndarray:
    """(N, 4, 4) OpenCV-convention T_pointcloud_camera fly-through poses."""
    poses = np.asarray(
        [c["T_pointcloud_camera"] for c in cameras_json], np.float64
    ).reshape(-1, 4, 4)
    poses = pose_opencv_to_opengl(poses)
    oriented, transform3x4 = auto_orient_and_center_poses(poses, method=method)
    transform = np.eye(4)
    transform[:3, :] = transform3x4
    ellipse = generate_ellipse_path(oriented[:, :3, :], n_frames=n_frames)
    out = np.tile(np.eye(4), (len(ellipse), 1, 1))
    out[:, :3, :] = ellipse
    out = np.linalg.inv(transform)[None] @ out
    return pose_opencv_to_opengl(out).astype(np.float32)


def main():
    parser = argparse.ArgumentParser(
        "Generate ellipse path from training cameras")
    parser.add_argument("--cameras", type=str, required=True,
                        help="train.json with all camera poses")
    parser.add_argument("--n_frames", type=int, default=120)
    parser.add_argument("--orient_method", type=str, default="up",
                        choices=["pca", "up", "vertical", "none"])
    parser.add_argument("--output", type=str, default="ellipse_path.pt")
    args = parser.parse_args()
    with open(args.cameras) as f:
        cameras_json = json.load(f)
    out = ellipse_path_from_dataset(cameras_json, args.n_frames,
                                    args.orient_method)
    import torch

    torch.save(torch.from_numpy(out), args.output)
    print(f"saved {out.shape[0]} poses to {args.output}")


if __name__ == "__main__":
    main()
