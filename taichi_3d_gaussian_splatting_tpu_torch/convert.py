"""The JAX package's state, as numpy arrays, turned into the port's.

Arrays of the JAX package convert with ``np.asarray`` on the caller's side;
nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import Camera


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
