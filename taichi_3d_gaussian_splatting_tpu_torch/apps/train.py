"""Training CLI. Port of ``taichi_3d_gaussian_splatting_tpu/apps/train.py``.

    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.train \\
        --train_config cfg.yaml [--device cpu]

``--gen_template_only`` writes the default config to ``--train_config``
and exits. The trainer runs on the card unless ``--device`` says otherwise
(``cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import argparse


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
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        GaussianPointCloudTrainer,
    )

    GaussianPointCloudTrainer(config, device=args.device).train()


if __name__ == "__main__":
    main()
