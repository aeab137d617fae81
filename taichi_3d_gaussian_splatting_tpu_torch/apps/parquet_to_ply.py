"""Scene .parquet -> graphdeco .ply converter.

Port of ``taichi_3d_gaussian_splatting_tpu/apps/parquet_to_ply.py``: the
scene is read unpadded with ``from_parquet`` and written with ``to_ply``,
on the CPU.

    python -m taichi_3d_gaussian_splatting_tpu_torch.apps.parquet_to_ply \\
        --parquet_path scene.parquet --ply_path scene.ply
"""
from __future__ import annotations

import argparse

from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
from taichi_3d_gaussian_splatting_tpu_torch.models.scene import SceneConfig


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--parquet_path", type=str, required=True)
    parser.add_argument("--ply_path", type=str, required=True)
    args = parser.parse_args(argv)
    scene = scene_lib.from_parquet(
        args.parquet_path, SceneConfig(max_num_points_ratio=None),
        device="cpu")
    scene_lib.to_ply(scene, args.ply_path)


if __name__ == "__main__":
    main()
