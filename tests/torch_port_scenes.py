"""Seeded numpy inputs shared by the port's tests (tests/test_torch_*.py).

numpy only at import (``small_frame`` imports torch and the port when
called), so the card-only tests can use it on a machine without JAX.
The shapes are those of ``make_scene``/``make_camera`` in
tests/test_rasterizer.py: 64x64 pixels and 100-200 points; the card-only
tests also take ``make_truck_scene`` at the Truck cell's 428,687 points.
"""
import numpy as np

Q_ID = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
T_ID = np.zeros((3,), np.float32)


def make_scene(n=200, seed=7):
    """(xyz (n, 3), features (n, 56), invalid (n,)) float32/bool arrays; the
    first n // 20 slots are invalid."""
    rng = np.random.default_rng(seed)
    xyz = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
         rng.uniform(2.0, 8.0, n)], axis=-1
    ).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3.5, -1.5, (n, 3))
    feats[:, 7] = rng.uniform(-1.0, 3.0, n)
    feats[:, 8:] = rng.normal(size=(n, 48)) * 0.3
    invalid = np.zeros((n,), bool)
    invalid[: n // 20] = True
    return xyz, feats, invalid


def make_K(w=64, h=64, f=60.0):
    return np.asarray([[f, 0.0, w / 2], [0.0, f, h / 2],
                       [0.0, 0.0, 1.0]], np.float32)


def small_frame(dev, tile=(32, 32), n=200, seed=7, scale_shift=0.0):
    """A 64x64 frame of ``make_scene(n, seed)`` (splat log-scales shifted
    by ``scale_shift``) at the identity pose, on ``dev``: (cfg, camera, raw
    attributes, radius, invalid, (xyz, features, invalid))."""
    import torch

    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    xyz, feats, invalid = make_scene(n, seed)
    feats[:, 4:7] += scale_shift
    cfg = R.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    raw, radius = R.compute_raw_attrs(to(xyz), to(feats), to(Q_ID), to(T_ID),
                                      cam)
    return cfg, cam, raw, radius, to(invalid), (to(xyz), to(feats),
                                                to(invalid))


def make_truck_scene(n, seed=20_000_003):
    """(xyz, features, invalid) of a seeded Truck-like scene of n points: 60%
    in a box in front of the identity camera, the rest on a shell behind
    and beside it, splats sized to cover a handful of pixels at street
    depth (seen by ``make_K(960, 544, 580.0)``)."""
    rng = np.random.default_rng(seed)
    vis = rng.random(n) < 0.6
    theta = rng.uniform(0.6 * np.pi, 1.4 * np.pi, n)
    rad = rng.uniform(5.0, 30.0, n)
    xyz = np.where(vis[:, None], np.stack(
        [rng.uniform(-8, 8, n), rng.uniform(-4, 4, n),
         rng.uniform(1, 30, n)], -1), np.stack(
        [rad * np.sin(theta), rng.uniform(-4, 4, n),
         rad * np.cos(theta)], -1)).astype(np.float32)
    feats = np.empty((n, 56), np.float32)
    q = rng.normal(size=(n, 4))
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-4.5, -2.0, (n, 3))
    feats[:, 7] = rng.uniform(-2.0, 3.0, n)
    feats[:, 8:] = rng.normal(size=(n, 48)) * 0.3
    return xyz, feats, np.zeros((n,), bool)


def make_odd_scene(n=160, seed=3):
    """A scene with the rows that exercise the guards: zero (invalid) rows,
    points behind the camera, one at the camera centre, and one on the
    camera plane."""
    xyz, feats, invalid = make_scene(n, seed)
    xyz[: n // 10, 2] *= -1.0           # behind the camera
    xyz[n // 10] = 0.0                  # at the camera centre
    xyz[n // 10 + 1, 2] = 0.0           # on the camera plane
    xyz[-4:] = 0.0                      # zero-padded pool slots
    feats[-4:] = 0.0
    invalid[-4:] = True
    return xyz, feats, invalid


def make_saturating_scene(n=300, seed=11):
    """tests/test_rasterizer.py::test_saturation_path: nearly opaque splats
    (opacity logit 8, so alpha > 0.99) stacked on the optical axis."""
    rng = np.random.default_rng(seed)
    xyz = np.stack(
        [rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
         rng.uniform(2.0, 3.0, n)], -1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    feats[:, 3] = 1.0
    feats[:, 4:7] = -0.5
    feats[:, 7] = 8.0
    feats[:, 8] = rng.normal(size=n)
    return xyz, feats, np.zeros((n,), bool)


def make_train_scene(n=128, seed=0):
    """tests/test_training.py::make_scene as numpy arrays (xyz, features,
    invalid)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack(
        [rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n),
         rng.uniform(2.0, 4.0, n)], axis=-1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = -2.0
    feats[:, 7] = 0.0
    feats[:, 8] = rng.normal(size=n)
    feats[:, 24] = rng.normal(size=n)
    feats[:, 40] = rng.normal(size=n)
    return xyz, feats, np.zeros((n,), bool)


def synthetic_target(hw=32):
    """tests/test_training.py::synthetic_target."""
    y, x = np.mgrid[0:hw, 0:hw] / hw
    return np.stack([x, y, 0.5 * (x + y)], axis=-1).astype(np.float32)


K32 = np.asarray([[24.0, 0, 16.0], [0, 24.0, 16.0], [0, 0, 1.0]], np.float32)


def host_scalar_adam(tx, grad, state, param):
    """``tx.update`` (the port's Adam) with its bias corrections numpy's f32
    scalars and its learning rate a Python double, all host floats:
    (new param, mu, nu)."""
    count = int(state.count) + 1
    mu = (1.0 - tx.b1) * grad + tx.b1 * state.mu
    nu = (1.0 - tx.b2) * (grad * grad) + tx.b2 * state.nu
    bc1 = float(np.float32(1.0) - np.float32(tx.b1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(tx.b2) ** np.float32(count))
    lr = tx.lr0
    if tx.decay_interval:
        lr = tx.lr0 * tx.decay_rate ** ((count - 1) // tx.decay_interval)
    u = (mu / bc1) / ((nu / bc2).sqrt() + tx.eps)
    return param + (-lr) * u, mu, nu
