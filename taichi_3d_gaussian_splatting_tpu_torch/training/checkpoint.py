"""Full training-state checkpoint and resume.

Port of ``taichi_3d_gaussian_splatting_tpu/training/checkpoint.py``: the
whole ``TrainState`` (scene, both Adam states with their update counts,
the controller's accumulators, and under pose refinement the pose deltas
with their Adam state) plus host metadata (iteration, best PSNR,
the densify generator's state) round-trips through a directory of ``.npy``
leaves and a JSON manifest. Leaves are saved by index in the fixed order of
``state_leaves``; the JAX package's checkpoints are not read.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import List, Tuple

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.models.scene import GaussianScene
from taichi_3d_gaussian_splatting_tpu_torch.training.controller import (
    ControllerState,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    AdamState,
    TrainState,
)


POSE_OPT_KEYS = ("mu", "nu", "count")


def state_leaves(state: TrainState) -> List:
    """The state's leaves in their fixed order: the scene's four tensors,
    each Adam's mu, nu and count (a () int64 tensor, saved as an int64
    scalar), the controller's six tensors,
    and when the state has them the pose deltas and their Adam's mu, nu
    and per-row count."""
    leaves = list(state.scene)
    for opt in (state.feat_opt, state.pos_opt):
        leaves += [opt.mu, opt.nu, opt.count]
    leaves += list(state.ctrl)
    if state.pose_deltas is not None:
        leaves += [state.pose_deltas] + [state.pose_opt[k]
                                         for k in POSE_OPT_KEYS]
    return leaves


def _state_from_leaves(leaves: List) -> TrainState:
    scene = GaussianScene(*leaves[0:4])
    # an Adam count comes back as the template holds it: a device tensor
    # (or a host int)
    feat = AdamState(leaves[4], leaves[5], leaves[6])
    pos = AdamState(leaves[7], leaves[8], leaves[9])
    n_ctrl = len(ControllerState._fields)
    pose = leaves[10 + n_ctrl:]
    return TrainState(scene=scene, feat_opt=feat, pos_opt=pos,
                      ctrl=ControllerState(*leaves[10:10 + n_ctrl]),
                      pose_deltas=pose[0] if pose else None,
                      pose_opt=dict(zip(POSE_OPT_KEYS, pose[1:])) if pose
                      else None)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf, np.int64)  # an Adam count held as a host int


def _spec(leaf) -> Tuple[tuple, str]:
    """(shape, numpy dtype name) of a leaf, without copying it."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")
    return (), "int64"


def save_checkpoint(path: str, state: TrainState, metadata: dict) -> None:
    """Write the state's leaves and ``metadata`` under ``path``, atomically.

    Leaves go to ``<path>.tmp`` and are swapped in with renames: a crash
    mid-save must never corrupt the previous checkpoint (leaf count and
    shapes are the same across saves, so a half-overwritten directory would
    pass every load-time check and restore a mixed state)."""
    base = path.rstrip("/")
    tmp, old = base + ".tmp", base + ".old"
    for d in (tmp, old):
        if os.path.exists(d):
            shutil.rmtree(d)
    os.makedirs(tmp)
    leaves = state_leaves(state)
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i:04d}.npy"), _as_numpy(leaf))
    manifest = dict(metadata)
    manifest["num_leaves"] = len(leaves)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(base):
        os.rename(base, old)
    os.rename(tmp, base)
    if os.path.exists(old):
        shutil.rmtree(old)


def load_checkpoint(path: str, template: TrainState) -> Tuple[TrainState,
                                                               dict]:
    """The state saved under ``path``, with ``template``'s leaf count,
    shapes, dtypes and device, and its metadata. A mismatch raises
    ValueError."""
    base = path.rstrip("/")
    if not os.path.exists(base) and os.path.exists(base + ".old"):
        # a crash between the two swap renames: the previous checkpoint
        # survives under .old
        base = base + ".old"
    with open(os.path.join(base, "manifest.json")) as f:
        metadata = json.load(f)
    want = state_leaves(template)
    if metadata["num_leaves"] != len(want):
        raise ValueError(
            f"checkpoint has {metadata['num_leaves']} leaves, the template "
            f"needs {len(want)}: config/scene shape mismatch")
    restored = []
    for i, w in enumerate(want):
        got = np.load(os.path.join(base, f"leaf_{i:04d}.npy"))
        shape, dtype = _spec(w)
        if got.shape != shape:
            raise ValueError(f"leaf {i} shape mismatch: checkpoint "
                             f"{got.shape} vs template {shape}")
        if str(got.dtype) != dtype:
            raise ValueError(f"leaf {i} dtype mismatch: checkpoint "
                             f"{got.dtype} vs template {dtype}")
        restored.append(torch.from_numpy(got).to(w.device)
                        if isinstance(w, torch.Tensor) else int(got))
    return _state_from_leaves(restored), metadata
