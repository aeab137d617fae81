"""Fixed-capacity Gaussian scene state + interchange I/O.

Port of ``taichi_3d_gaussian_splatting_tpu/models/scene.py``. The scene is a
NamedTuple of tensors on one device:

- ``xyz`` (N, 3) and ``features`` (N, 56), the optimizable leaves;
- ``invalid`` (N,) bool and ``object_id`` (N,) int32, buffers;
- the pool may be pre-padded to a fixed capacity (``max_num_points_ratio``),
  padded slots being invalid.

Feature layout: [0:4] quat xyzw | [4:7] log scale | [7] pre-sigmoid alpha |
[8:24] SH-R | [24:40] SH-G | [40:56] SH-B.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

NUM_FEATURES = 56
SH_C0 = 0.28209479177387814

FEATURE_COLUMNS = (
    [f"cov_q{i}" for i in range(4)]
    + [f"cov_s{i}" for i in range(3)]
    + ["alpha0"]
    + [f"r_sh{i}" for i in range(16)]
    + [f"g_sh{i}" for i in range(16)]
    + [f"b_sh{i}" for i in range(16)]
)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    max_num_points_ratio: Optional[float] = None
    add_sphere: bool = False
    sphere_radius_factor: float = 4.0
    num_points_sphere: int = 10000
    max_initial_covariance: Optional[float] = None
    initial_alpha: float = -2.0
    initial_covariance_ratio: float = 1.0


class GaussianScene(NamedTuple):
    xyz: torch.Tensor        # (N, 3) f32
    features: torch.Tensor   # (N, 56) f32
    invalid: torch.Tensor    # (N,) bool, padded/pruned slots
    object_id: torch.Tensor  # (N,) int32

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def num_valid(self) -> torch.Tensor:
        return torch.sum(~self.invalid)


def create_scene(point_cloud: np.ndarray, config: SceneConfig,
                 rgb: Optional[np.ndarray] = None,
                 features: Optional[np.ndarray] = None,
                 object_id: Optional[np.ndarray] = None, seed: int = 0,
                 device="cuda") -> GaussianScene:
    """Build a scene from a raw point cloud, optionally pre-padded.

    Initialization: isotropic log-scale from the mean distance to the 3
    nearest neighbors, random uniform normalized quaternion, the
    initial_alpha logit, SH DC = 1.0 or logit(rgb)/C0.
    """
    point_cloud = np.asarray(point_cloud, np.float32)
    n = point_cloud.shape[0]
    cap = n
    if config.max_num_points_ratio is not None:
        cap = int(n * config.max_num_points_ratio)
        if cap <= n:
            raise ValueError("max_num_points_ratio must be > 1.0")

    xyz = np.zeros((cap, 3), np.float32)
    xyz[:n] = point_cloud
    invalid = np.ones((cap,), bool)
    invalid[:n] = False

    if features is not None:
        feats = np.zeros((cap, NUM_FEATURES), np.float32)
        feats[:n] = np.asarray(features, np.float32)
    else:
        feats = _initialize_features(point_cloud, cap, config, rgb, seed)

    oid = np.zeros((cap,), np.int32)
    if object_id is not None:
        oid[:n] = np.asarray(object_id, np.int32)

    return GaussianScene(
        xyz=torch.from_numpy(xyz).to(device),
        features=torch.from_numpy(feats).to(device),
        invalid=torch.from_numpy(invalid).to(device),
        object_id=torch.from_numpy(oid).to(device),
    )


def _initialize_features(point_cloud, cap, config, rgb, seed):
    from scipy.spatial import cKDTree

    n = point_cloud.shape[0]
    feats = np.zeros((cap, NUM_FEATURES), np.float32)

    tree = cKDTree(point_cloud)
    k = min(4, n)
    dist, _ = tree.query(point_cloud, k=k)
    if k > 1:
        dist = np.atleast_2d(dist)
        mean_nn = dist[:, 1:].mean(axis=1)
    else:
        mean_nn = np.ones((n,), np.float32)
    # cKDTree fills absent neighbors with inf (n < 4): unit scale instead
    mean_nn = np.where(np.isfinite(mean_nn), mean_nn, 1.0)
    initial_cov = mean_nn * config.initial_covariance_ratio
    initial_cov = np.clip(initial_cov, 1e-6, config.max_initial_covariance)
    feats[:n, 4:7] = np.log(initial_cov)[:, None]

    rng = np.random.default_rng(seed)
    q = rng.random((cap, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 0:4] = q

    feats[:, 7] = config.initial_alpha
    feats[:, 8] = 1.0
    feats[:, 24] = 1.0
    feats[:, 40] = 1.0
    if rgb is not None:
        # positive lower clip: black points would get -inf DC features
        rgb = np.clip(np.asarray(rgb, np.float32) / 255.0, 1e-3, 0.99)
        logit = np.log(rgb / (1.0 - rgb))
        feats[:n, 8] = logit[:, 0] / SH_C0
        feats[:n, 24] = logit[:, 1] / SH_C0
        feats[:n, 40] = logit[:, 2] / SH_C0
    return feats


def to_parquet(scene: GaussianScene, path: str) -> None:
    """Write the valid points as a parquet of x, y, z and the 56 feature
    columns."""
    import pandas as pd

    valid = ~scene.invalid.cpu().numpy()
    xyz = scene.xyz.detach().cpu().numpy()[valid]
    feats = scene.features.detach().cpu().numpy()[valid]
    df = pd.concat([pd.DataFrame(xyz, columns=["x", "y", "z"]),
                    pd.DataFrame(feats, columns=FEATURE_COLUMNS)], axis=1)
    df.to_parquet(path)


def from_parquet(path: str, config: SceneConfig = SceneConfig(),
                 seed: int = 0, device="cuda") -> GaussianScene:
    """Load a raw (x, y, z[, r, g, b]) or trained scene parquet."""
    import pandas as pd

    df = pd.read_parquet(path)
    if config.add_sphere:
        df = _add_sphere(df, config.sphere_radius_factor,
                         config.num_points_sphere, seed)
    point_cloud = df[["x", "y", "z"]].to_numpy(np.float32)
    has_color = all(c in df.columns for c in ("r", "g", "b"))
    rgb = df[["r", "g", "b"]].to_numpy(np.float32) if has_color else None
    if set(FEATURE_COLUMNS).issubset(df.columns):
        feats = np.array(df[FEATURE_COLUMNS].to_numpy(np.float32))
        bad = ~np.isfinite(feats).all(axis=1)
        if bad.any():
            # sphere rows appended to a trained parquet carry no feature
            # columns (NaN): give them a fresh init
            init = _initialize_features(
                point_cloud, point_cloud.shape[0], config, rgb, seed)
            feats[bad] = init[bad]
        return create_scene(point_cloud, config, features=feats, seed=seed,
                            device=device)
    return create_scene(point_cloud, config, rgb=rgb, seed=seed,
                        device=device)


def _add_sphere(df, radius_factor: float, num_points: int, seed: int = 0):
    """Enclosing sky-sphere point injection."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    has_color = all(c in df.columns for c in ("r", "g", "b"))
    far = max(
        df["x"].max() - df["x"].min(),
        df["y"].max() - df["y"].min(),
        df["z"].max() - df["z"].min(),
    ) / 2.0
    radius = far * radius_factor
    phi = 2.0 * np.pi * rng.random(num_points)
    theta = np.arccos(2.0 * rng.random(num_points) - 1.0)
    pts = np.stack([radius * np.sin(theta) * np.cos(phi),
                    radius * np.sin(theta) * np.sin(phi),
                    radius * np.cos(theta)], axis=1)
    cols = ["x", "y", "z"]
    if has_color:
        pts = np.concatenate([pts, np.full((num_points, 3), 255 // 2)], axis=1)
        cols += ["r", "g", "b"]
    return pd.concat([df, pd.DataFrame(pts, columns=cols)])


def to_ply(scene: GaussianScene, path: str) -> None:
    """Export valid points in graphdeco-inria format (rotation reordered
    xyzw -> wxyz), binary little-endian."""
    valid = ~scene.invalid.cpu().numpy()
    xyz = scene.xyz.cpu().numpy()[valid]
    feats = scene.features.cpu().numpy()[valid]
    n = xyz.shape[0]
    f_sh = feats[:, 8:].reshape(-1, 3, 16)
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_sh[..., 0],
         f_sh[..., 1:].reshape(-1, 45), feats[:, 7:8], feats[:, 4:7],
         feats[:, [3, 0, 1, 2]]],
        axis=1,
    ).astype("<f4")
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(45)]
    names += ["opacity"] + [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names] + ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def from_ply(path: str, config: SceneConfig = SceneConfig(),
             device="cuda") -> GaussianScene:
    """Import a graphdeco .ply (the inverse of to_ply)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line.startswith("property"):
                # a non-float property would shift the 4-byte record stride
                raise ValueError(f"unsupported (non-float) PLY property: {line!r}")
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(names) * 4), dtype="<f4")
    data = data.reshape(n, len(names))
    col = {name: i for i, name in enumerate(names)}

    xyz = data[:, [col["x"], col["y"], col["z"]]]
    feats = np.zeros((n, NUM_FEATURES), np.float32)
    feats[:, [3, 0, 1, 2]] = data[:, [col[f"rot_{i}"] for i in range(4)]]
    feats[:, 4:7] = data[:, [col[f"scale_{i}"] for i in range(3)]]
    feats[:, 7] = data[:, col["opacity"]]
    f_sh = np.zeros((n, 3, 16), np.float32)
    f_sh[..., 0] = data[:, [col[f"f_dc_{i}"] for i in range(3)]]
    f_sh[..., 1:] = data[:, [col[f"f_rest_{i}"] for i in range(45)]].reshape(
        n, 3, 15)
    feats[:, 8:] = f_sh.reshape(n, 48)
    return create_scene(xyz, config, features=feats, device=device)


def merge_scenes(scenes: list) -> GaussianScene:
    """Concatenate scenes, giving each its own object id."""
    oid = torch.cat([
        torch.full((s.capacity,), i, dtype=torch.int32, device=s.xyz.device)
        for i, s in enumerate(scenes)])
    return GaussianScene(
        xyz=torch.cat([s.xyz for s in scenes]),
        features=torch.cat([s.features for s in scenes]),
        invalid=torch.cat([s.invalid for s in scenes]),
        object_id=oid,
    )
