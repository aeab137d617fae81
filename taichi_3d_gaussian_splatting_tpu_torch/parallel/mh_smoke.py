"""Multi-process smoke/equivalence harness: N processes, one DP train step.

Port of ``taichi_3d_gaussian_splatting_tpu/parallel/mh_smoke.py``. Each
process is one rank of a ``torch.distributed`` group (gloo on the CPU and
where ranks share a card, NCCL where each has its own; see
``multihost.choose_backend``) and runs a fixed deterministic training
sequence through the SAME ``data_parallel.make_dp_train_step`` the
trainer uses: the global batch of ``TOTAL_DEVICES`` cameras a step (fixed,
so results compare across rigs) split over the processes, each loading
only its own rows (``data_parallel.shard_batch``), the state replicated from
rank 0 (``multihost.broadcast_tree``), the sums spanning the process
boundary. Process 0 writes the final state to ``--out`` so a parent can
compare it with the single-process result (``single_process_reference``:
one process holding all ``TOTAL_DEVICES`` rows).

Usage (2 processes, 4 rows each):
  python -m taichi_3d_gaussian_splatting_tpu_torch.parallel.mh_smoke \\
      --coordinator 127.0.0.1:PORT --num_processes 2 --process_id I \\
      --steps 2 --out mh_I.npz [--device cpu]
"""
from __future__ import annotations

import argparse

TOTAL_DEVICES = 8      # fixed global batch: results comparable across rigs
HW = 64
N_POINTS = 256


def _scene_and_batches(steps: int):
    """Deterministic scene + per-step global camera batches (every process
    computes the identical stream; the JAX harness's numbers)."""
    import numpy as np

    rng = np.random.default_rng(42)
    xyz = np.stack(
        [rng.uniform(-0.9, 0.9, N_POINTS), rng.uniform(-0.9, 0.9, N_POINTS),
         rng.uniform(2.0, 4.5, N_POINTS)], axis=-1).astype(np.float32)
    feats = np.zeros((N_POINTS, 56), np.float32)
    q = rng.normal(size=(N_POINTS, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3.5, -2.0, (N_POINTS, 3))
    feats[:, 7] = rng.uniform(-1.5, 1.5, N_POINTS)
    feats[:, 8:] = (rng.normal(size=(N_POINTS, 48)) * 0.3).astype(np.float32)

    batches = []
    for _ in range(steps):
        images = rng.random((TOTAL_DEVICES, HW, HW, 3)).astype(np.float32)
        qs = np.tile(np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32),
                     (TOTAL_DEVICES, 1))
        ts = rng.normal(0, 0.05, (TOTAL_DEVICES, 3)).astype(np.float32)
        Ks = np.tile(np.asarray(
            [[[48.0, 0.0, HW / 2], [0.0, 48.0, HW / 2], [0.0, 0.0, 1.0]]],
            np.float32), (TOTAL_DEVICES, 1, 1))
        batches.append((images, qs, ts, Ks))
    return xyz, feats, batches


def _make_step_inputs(device):
    import torch

    from taichi_3d_gaussian_splatting_tpu_torch.models.scene import (
        GaussianScene,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        RasterizerConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        TrainConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
        LossConfig,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        init_train_state,
    )

    config = TrainConfig(
        rasterisation_config=RasterizerConfig(tile_size=32),
        loss_function_config=LossConfig(enable_regularization=False),
        feature_learning_rate=1e-2,
    )

    def build_state(xyz, feats):
        put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        scene = GaussianScene(
            xyz=put(xyz), features=put(feats),
            invalid=torch.zeros((N_POINTS,), dtype=torch.bool, device=device),
            object_id=torch.zeros((N_POINTS,), dtype=torch.int32,
                                  device=device))
        return init_train_state(scene, config)

    return config, build_state


def _run(steps: int, device, local_count: int) -> dict:
    """The sequence on this rank's ``local_count`` rows of every batch."""
    import numpy as np

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
        shard_batch,
    )

    config, build_state = _make_step_inputs(device)
    xyz, feats, batches = _scene_and_batches(steps)
    state = mh.broadcast_tree(build_state(xyz, feats))
    step = make_dp_train_step(config, HW, HW, device=device)
    losses = []
    for images, qs, ts, Ks in batches:
        rows = shard_batch(images, qs, ts, Ks, local_count=local_count,
                           device=device)
        state, metrics, _ = step(state, *rows, 3)
        losses.append(float(metrics["loss"]))
    print(f"mh_smoke rank {mh.rank()}/{mh.world_size()}: losses={losses}",
          flush=True)
    return {
        "losses": np.asarray(losses, np.float64),
        "features": state.scene.features.cpu().numpy(),
        "xyz": state.scene.xyz.cpu().numpy(),
        "num_in_camera": state.ctrl.num_in_camera.cpu().numpy(),
        # Adam's first moments: linear in the step's gradients
        "feat_mu": state.feat_opt.mu.cpu().numpy(),
        "pos_mu": state.pos_opt.mu.cpu().numpy(),
    }


def run_worker(coordinator: str | None, num_processes: int, process_id: int,
               steps: int, out: str | None, device="cuda") -> dict:
    """Join the group, run the sequence, return (and maybe save) results.
    In a process that is already a rank of a group of ``num_processes``,
    ``coordinator`` may be None: the group is used as it is."""
    import numpy as np

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if TOTAL_DEVICES % num_processes:
        raise ValueError(f"{num_processes} processes cannot split the "
                         f"global batch of {TOTAL_DEVICES}")
    mh.initialize(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id,
                  device=device)
    result = _run(steps, mh.rank_device(device),
                  TOTAL_DEVICES // num_processes)
    if out and mh.is_main():
        np.savez(out, **result)
    return result


def single_process_reference(steps: int, device="cuda") -> dict:
    """The same sequence in one process holding all ``TOTAL_DEVICES`` rows
    (no process group)."""
    return _run(steps, device, TOTAL_DEVICES)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num_processes", type=int, required=True)
    ap.add_argument("--process_id", type=int, required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of "
                    "the kernels over gloo")
    args = ap.parse_args()
    run_worker(args.coordinator, args.num_processes, args.process_id,
               args.steps, args.out, args.device)
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    mh.shutdown()


if __name__ == "__main__":
    main()
