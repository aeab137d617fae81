"""Training CLI. Port of ``taichi_3d_gaussian_splatting_tpu/apps/train.py``.

    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.train \\
        --train_config cfg.yaml [--device cpu]

``--gen_template_only`` writes the default config to ``--train_config``
and exits. The trainer runs on the card unless ``--device`` says otherwise
(``cpu`` runs the kernels' plain versions).

Multi-device configs run one rank a device (``parallel/multihost.py``):
``data_parallel_devices: N`` or ``tile_parallel_devices: N`` spawns N
local ranks, unless ``torchrun`` launched the command (then each process
is a rank of the group it describes); ``multihost: true`` joins the group
of its ``coordinator_address``, ``num_processes`` and ``process_id`` (one
command a process) or torchrun's.
"""
from __future__ import annotations

import argparse


def train_rank(config, device) -> None:
    """One rank's training run (all of it on a single device)."""
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        GaussianPointCloudTrainer,
    )

    trainer = GaussianPointCloudTrainer(config, device=device)
    trainer.train()
    if trainer.writer is not None:
        # before the process exits: a spawned rank's exit would close the
        # writer's queue under its thread
        trainer.writer.close()


def main(argv=None):
    parser = argparse.ArgumentParser("Train a Gaussian Point Cloud Scene")
    parser.add_argument("--train_config", type=str, required=True)
    parser.add_argument("--gen_template_only", action="store_true",
                        default=False)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain versions "
                        "of the kernels")
    args = parser.parse_args(argv)

    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        load_config,
        save_template,
    )

    if args.gen_template_only:
        save_template(args.train_config)
        return
    config = load_config(args.train_config)
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    ranks = max(config.data_parallel_devices, config.tile_parallel_devices)
    if (ranks > 1 and not config.multihost
            and not mh.launched_by_torchrun()):
        mh.run_local_ranks(train_rank, ranks, args=(config, args.device),
                           device=args.device)
        return
    train_rank(config, args.device)
    mh.shutdown()  # leaves the group the trainer joined, if any


if __name__ == "__main__":
    main()
