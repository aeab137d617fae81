#!/usr/bin/env python3
"""The port's single train step in two checkouts, bit for bit, on the CPU.

    python3 kernel_variants/step_bits.py OTHER_ROOT [--steps 300]

Runs ``--steps`` single steps of ``make_train_step`` in this checkout and
in ``OTHER_ROOT`` (for example a ``git archive`` of the parent commit),
each in a process of its own with that root first on ``sys.path``: the
64x64 frame and 200-point scene of ``tests/torch_port_scenes.py``, two
uint8 targets, a random translation a step, the position learning rate
decaying every 7 updates and the SH band rising every 50 steps; once
without and once with pose refinement (two views, the first 3 steps at
index -1). Prints, for each, the state leaves that differ and exits 1 if
any do.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def worker(root: str, out: str, steps: int, pose: bool) -> None:
    """The steps in the checkout at ``root``; the state leaves to ``out``."""
    sys.path[:0] = [root, str(Path(root) / "tests")]
    import torch
    from torch_port_scenes import Q_ID, make_K, make_scene

    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        scene_from_jax_arrays,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        TrainConfig,
    )

    config = TrainConfig(
        rasterisation_config=R.RasterizerConfig(tile_size=32),
        position_learning_rate_decay_interval=7, pose_refinement=pose,
        pose_learning_rate=1e-3)
    state = trainer.init_train_state(
        scene_from_jax_arrays(*make_scene(200, 7), device="cpu"), config,
        num_train_images=2)
    step = trainer.make_train_step(config, 64, 64, device="cpu")
    rng = np.random.default_rng(1)
    gts = [torch.from_numpy((rng.random((64, 64, 3)) * 255).astype(
        np.uint8)) for _ in range(2)]
    q, K = torch.from_numpy(Q_ID), torch.from_numpy(make_K())
    for i in range(steps):
        t = torch.from_numpy(rng.normal(0, 0.05, 3).astype(np.float32))
        state = step(state, gts[i % 2], q, t, K, min(i // 50, 3),
                     -1 if i < 3 else i % 2)[0]
    leaves = {"xyz": state.scene.xyz, "features": state.scene.features,
              "feat_mu": state.feat_opt.mu, "feat_nu": state.feat_opt.nu,
              "pos_mu": state.pos_opt.mu, "pos_nu": state.pos_opt.nu,
              "count": torch.as_tensor(state.feat_opt.count)}
    leaves.update({"ctrl_" + k: v for k, v in state.ctrl._asdict().items()})
    if pose:
        leaves["pose_deltas"] = state.pose_deltas
        leaves.update({"pose_" + k: v for k, v in state.pose_opt.items()})
    np.savez(out, **{k: v.detach().numpy() for k, v in leaves.items()})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_root")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--worker", nargs=3, metavar=("ROOT", "OUT", "POSE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        root, out, pose = args.worker
        worker(root, out, args.steps, pose == "1")
        return 0
    differ = False
    with tempfile.TemporaryDirectory() as tmp:
        for pose in ("0", "1"):
            outs = []
            for name, root in (("this", ROOT), ("other", args.other_root)):
                out = str(Path(tmp) / f"{name}_{pose}.npz")
                subprocess.run([sys.executable, __file__, args.other_root,
                                "--steps", str(args.steps), "--worker",
                                str(Path(root).resolve()), out, pose],
                               check=True)
                outs.append(np.load(out))
            a, b = outs
            bad = [k for k in a.files if not np.array_equal(a[k], b[k])]
            differ |= bool(bad)
            print(f"pose refinement {pose == '1'}: {args.steps} steps, "
                  f"{len(a.files)} state leaves, differing: {bad or 'none'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
