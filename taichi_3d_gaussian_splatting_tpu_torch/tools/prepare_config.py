"""Fill dataset paths into a template YAML. Reference: tools/prepare_config.py.

Port of
``taichi_3d_gaussian_splatting_tpu/tools/prepare_config.py``,
a copy that runs on the host alone (no device, no torch).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import yaml


def main():
    parser = argparse.ArgumentParser(
        "Prepare training for 3D Gaussian Splatting")
    parser.add_argument("--example_config", type=str, required=True)
    parser.add_argument("--input_prefix", type=str, required=True,
                        help="path prefix to train.json/val.json/point_cloud.parquet")
    parser.add_argument("--output", type=str, default="train.yaml")
    args = parser.parse_args()
    with open(args.example_config) as f:
        config = yaml.safe_load(f)
    prefix = Path(args.input_prefix)
    config["train-dataset-json-path"] = str(prefix / "train.json")
    config["val-dataset-json-path"] = str(prefix / "val.json")
    config["pointcloud-parquet-path"] = str(prefix / "point_cloud.parquet")
    config["summary-writer-log-dir"] = args.input_prefix
    config["output-model-dir"] = args.input_prefix
    with open(args.output, "w") as f:
        yaml.safe_dump(config, f)


if __name__ == "__main__":
    main()
