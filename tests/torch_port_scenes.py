"""Seeded numpy inputs shared by the port's tests (tests/test_torch_*.py).

numpy only, so the card-only tests can use it on a machine without JAX.
The shapes are those of ``make_scene``/``make_camera`` in
tests/test_rasterizer.py: 64x64 pixels and 100-200 points.
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


def make_K(w=64, h=64):
    return np.asarray([[60.0, 0.0, w / 2], [0.0, 60.0, h / 2],
                       [0.0, 0.0, 1.0]], np.float32)


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
