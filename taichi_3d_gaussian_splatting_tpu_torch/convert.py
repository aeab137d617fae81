"""The JAX package's state, as numpy arrays, turned into the port's:
scenes, cameras and training states.

Arrays of the JAX package convert with ``np.asarray`` on the caller's side;
nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import Camera
from taichi_3d_gaussian_splatting_tpu_torch.training.controller import (
    ControllerState,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    AdamState,
    TrainState,
)


def scene_from_jax_arrays(xyz, features, invalid, object_id=None,
                          device="cuda") -> GaussianScene:
    """(N, 3) xyz, (N, 56) features, (N,) invalid and (N,) object ids (None
    for all zeros) -> a GaussianScene on ``device``."""
    xyz = np.asarray(xyz, np.float32)
    if object_id is None:
        object_id = np.zeros((xyz.shape[0],), np.int32)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)

    return GaussianScene(xyz=put(xyz, np.float32),
                         features=put(features, np.float32),
                         invalid=put(invalid, bool),
                         object_id=put(object_id, np.int32))


def camera_from_jax(K, width: int, height: int, device="cuda") -> Camera:
    """(3, 3) intrinsics and the image size -> a Camera on ``device``."""
    return Camera(K=torch.from_numpy(np.array(K, dtype=np.float32)).to(device),
                  width=int(width), height=int(height))


def _field(obj, name: str):
    """``obj[name]`` for a mapping, ``obj.name`` otherwise."""
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def train_state_from_jax(scene, feat_adam, pos_adam, ctrl, pose_deltas=None,
                         pose_opt=None, device="cuda") -> TrainState:
    """The JAX package's training state -> the port's TrainState on
    ``device``. ``scene``: xyz, features, invalid, object_id; ``feat_adam``
    and ``pos_adam``: optax's Adam state (mu, nu, count) of the features
    and of the positions; ``ctrl``: the ControllerState fields. Each is a
    mapping or an object with those attributes, of array-likes. Under pose
    refinement, ``pose_deltas`` (num_images, 6) and ``pose_opt`` (a mapping
    of mu, nu and the per-row count, as ``init_pose_opt`` makes it)."""
    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def adam(s):
        count = int(np.asarray(_field(s, "count")))
        return AdamState(mu=put(_field(s, "mu")), nu=put(_field(s, "nu")),
                         count=torch.full((), count, dtype=torch.int64,
                                          device=device))

    return TrainState(
        scene=scene_from_jax_arrays(
            _field(scene, "xyz"), _field(scene, "features"),
            _field(scene, "invalid"), _field(scene, "object_id"),
            device=device),
        feat_opt=adam(feat_adam), pos_opt=adam(pos_adam),
        ctrl=ControllerState(*(put(_field(ctrl, f))
                               for f in ControllerState._fields)),
        pose_deltas=None if pose_deltas is None else put(pose_deltas),
        pose_opt=None if pose_opt is None else {
            k: put(_field(pose_opt, k)) for k in ("mu", "nu", "count")})
