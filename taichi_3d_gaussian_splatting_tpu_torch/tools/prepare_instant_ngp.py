"""Instant-NGP / BlenderNeRF transforms.json -> dataset jsons + point cloud.

Port of
``taichi_3d_gaussian_splatting_tpu/tools/prepare_instant_ngp.py``,
a copy that runs on the host alone (no device, no torch).

Behavioral reference: tools/prepare_InstantNGP_with_mesh.py. Cameras use
the Blender/OpenGL convention; the flip_x matrix converts to the OpenCV
x-right/y-down/z-forward frame the rasterizer expects (:36-44). The initial
point cloud is sampled from a mesh surface (ply_io replaces trimesh).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

BLENDER_TO_OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64
)


def convert_transforms(input_json: dict, image_path_prefix: str) -> list:
    """transforms.json frames -> dataset records (reference :11-54).
    Global intrinsics may be overridden per frame."""
    def intrinsics_of(d, fallback=None):
        if all(k in d for k in ("fl_x", "fl_y", "cx", "cy")):
            return np.array(
                [[d["fl_x"], 0, d["cx"]], [0, d["fl_y"], d["cy"]], [0, 0, 1]]
            )
        return fallback

    K = intrinsics_of(input_json)
    width = input_json.get("w")
    height = input_json.get("h")
    records = []
    for frame in input_json["frames"]:
        K = intrinsics_of(frame, K)
        width = frame.get("w", width)
        height = frame.get("h", height)
        T_blender = np.asarray(frame["transform_matrix"], np.float64).reshape(4, 4)
        T_pointcloud_camera = T_blender @ BLENDER_TO_OPENCV
        records.append({
            "image_path": os.path.join(image_path_prefix, frame["file_path"]),
            "T_pointcloud_camera": T_pointcloud_camera.tolist(),
            "camera_intrinsics": np.asarray(K).tolist(),
            "camera_height": int(height),
            "camera_width": int(width),
            "camera_id": 0,
        })
    return records


def main():
    import pandas as pd

    from taichi_3d_gaussian_splatting_tpu_torch.tools.ply_io import (
        read_mesh, sample_mesh_surface,
    )

    parser = argparse.ArgumentParser()
    parser.add_argument("--transforms_train", type=str, required=True)
    parser.add_argument("--mesh_path", type=str, required=True)
    parser.add_argument("--mesh_sample_points", type=int, default=500)
    parser.add_argument("--transforms_test", type=str, default=None,
                        help="if absent, every val_sample-th train frame")
    parser.add_argument("--val_sample", type=int, default=8)
    parser.add_argument("--image_path_prefix", type=str, default="")
    parser.add_argument("--output_path", type=str, required=True)
    args = parser.parse_args()

    with open(args.transforms_train) as f:
        records = convert_transforms(json.load(f), args.image_path_prefix)
    if args.transforms_test is not None:
        with open(args.transforms_test) as f:
            val = convert_transforms(json.load(f), args.image_path_prefix)
        train = records
    else:
        train = [r for i, r in enumerate(records) if i % args.val_sample != 0]
        val = [r for i, r in enumerate(records) if i % args.val_sample == 0]

    os.makedirs(args.output_path, exist_ok=True)
    with open(os.path.join(args.output_path, "train.json"), "w") as f:
        json.dump(train, f, indent=4)
    with open(os.path.join(args.output_path, "val.json"), "w") as f:
        json.dump(val, f, indent=4)

    verts, faces = read_mesh(args.mesh_path)
    points = sample_mesh_surface(verts, faces, args.mesh_sample_points)
    pd.DataFrame(points, columns=["x", "y", "z"]).to_parquet(
        os.path.join(args.output_path, "point_cloud.parquet")
    )


if __name__ == "__main__":
    main()
