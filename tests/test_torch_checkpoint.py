"""The port's full training-state checkpoint (``training/checkpoint.py``):
a round trip of every leaf and the metadata, the recovery of the previous
checkpoint after a crash between the two swap renames, and the ValueErrors
of a mismatched template."""
import json
import os

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint as ck
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from tests.torch_port_scenes import make_scene


def _state(n=50, seed=2, offset=0.0):
    xyz, feats, invalid = make_scene(n, seed=seed)
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz + offset, feats, invalid,
                              np.arange(n) % 4, device="cpu"), TrainConfig())
    rng = np.random.default_rng(seed)

    def rand_like(t):
        return torch.from_numpy(rng.normal(size=tuple(t.shape)).astype(
            np.float32))

    return state._replace(
        feat_opt=trainer.AdamState(rand_like(state.feat_opt.mu),
                                   rand_like(state.feat_opt.nu), 7),
        pos_opt=trainer.AdamState(rand_like(state.pos_opt.mu),
                                  rand_like(state.pos_opt.nu), 9),
        ctrl=type(state.ctrl)(*[rand_like(t) for t in state.ctrl]))


def _assert_equal_states(a, b):
    la, lb = ck.state_leaves(a), ck.state_leaves(b)
    assert len(la) == len(lb) == 16
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y and isinstance(y, int)


def test_round_trip(tmp_path):
    state = _state()
    path = str(tmp_path / "checkpoint_latest")
    meta = {"iteration": 12, "best_psnr": 21.5, "rng_state": [1, 2, 3]}
    ck.save_checkpoint(path, state, meta)
    restored, got_meta = ck.load_checkpoint(path, _state(seed=4, offset=1.0))
    _assert_equal_states(restored, state)
    assert got_meta == dict(meta, num_leaves=16)
    # a second save replaces the first and leaves no .tmp or .old behind
    state2 = _state(seed=9)
    ck.save_checkpoint(path, state2, dict(meta, iteration=13))
    restored, got_meta = ck.load_checkpoint(path, state)
    _assert_equal_states(restored, state2)
    assert got_meta["iteration"] == 13
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_latest"]


def test_recovers_the_old_checkpoint(tmp_path):
    """A crash after the first swap rename (the old checkpoint moved to
    .old, the new one still in .tmp): the load finds the old one."""
    state = _state()
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, state, {"iteration": 3})
    os.rename(path, path + ".old")
    os.makedirs(path + ".tmp")  # a half-written new checkpoint
    restored, meta = ck.load_checkpoint(path, _state(seed=5))
    _assert_equal_states(restored, state)
    assert meta["iteration"] == 3
    ck.save_checkpoint(path, _state(seed=6), {"iteration": 4})
    assert sorted(os.listdir(tmp_path)) == ["ck"]


@pytest.mark.parametrize("kind", ["leaf_count", "shape", "dtype"])
def test_mismatch_raises(tmp_path, kind):
    state = _state()
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, state, {"iteration": 1})
    template = _state()
    if kind == "leaf_count":
        manifest = os.path.join(path, "manifest.json")
        with open(manifest) as f:
            data = json.load(f)
        data["num_leaves"] = 15
        with open(manifest, "w") as f:
            json.dump(data, f)
        match = "leaves"
    elif kind == "shape":
        template = _state(n=60)
        match = "shape mismatch"
    else:
        template = template._replace(scene=template.scene._replace(
            object_id=template.scene.object_id.long()))
        match = "dtype mismatch"
    with pytest.raises(ValueError, match=match):
        ck.load_checkpoint(path, template)
