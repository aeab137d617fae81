"""KITTI / Agisoft-XML dataset -> kitti_{train,val}.json + point cloud.

Port of
``taichi_3d_gaussian_splatting_tpu/tools/prepare_kitti.py``,
a copy that runs on the host alone (no device, no torch).

Behavioral reference: tools/prepare_kitti.py. Camera extrinsics come from
an Agisoft Metashape chunk XML (<camera><transform> is T_pointcloud_camera
row-major, :104-128); intrinsics from <sensor><calibration> with principal
point at the image center (:131-153). The LiDAR point cloud is downsampled
to 1% and wrapped in a Gaussian shell of background points (:63-80);
every 3rd frame goes to TRAIN (the reference's inverted split, :92).
"""
from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class _View:
    T_pointcloud_camera: np.ndarray
    label: str
    sensor_id: str
    path: str


def extrinsics_from_xml(xml_file: str, image_dir: str) -> List[_View]:
    root = ET.parse(xml_file).getroot()
    views = []
    for e in root.findall("chunk/cameras")[0].findall("camera"):
        label = e.get("label")
        sensor_id = e.get("sensor_id")
        tr = e.find("transform")
        if tr is None or tr.text is None:
            continue
        vals = [float(x) for x in tr.text.split() if x]
        if len(vals) != 16:
            continue
        T = np.asarray(vals, np.float32).reshape(4, 4)
        path = os.path.abspath(os.path.join(image_dir, f"{label}.png"))
        views.append(_View(T, label, sensor_id, path))
    views.sort(key=lambda v: v.label)
    return views


def intrinsics_from_xml(xml_file: str) -> Dict[str, dict]:
    root = ET.parse(xml_file).getroot()
    out = {}
    for sensor in root.findall("chunk/sensors/sensor"):
        calibration = sensor.find("calibration")
        resolution = calibration.find("resolution")
        width = float(resolution.get("width"))
        height = float(resolution.get("height"))
        f = float(calibration.find("f").text)
        K = np.array(
            [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32
        )
        out[sensor.get("id")] = {
            "K": K, "width": int(width), "height": int(height)
        }
    return out


def convert(camera_xml: str, point_cloud_ply: str, image_dir: str,
            output_dir: str, downsample_frac: float = 0.01,
            num_shell_points: int = 1000, seed: int = 1) -> None:
    import pandas as pd

    from taichi_3d_gaussian_splatting_tpu_torch.tools.ply_io import read_ply_points

    views = extrinsics_from_xml(camera_xml, image_dir)
    sensors = intrinsics_from_xml(camera_xml)
    points = read_ply_points(point_cloud_ply)

    os.makedirs(output_dir, exist_ok=True)
    df_pts = pd.DataFrame(points, columns=["x", "y", "z"])
    lo, hi = df_pts.min(), df_pts.max()
    center = (lo + hi) / 2.0
    radius = float((hi - lo).max()) / 2.0
    df_pts = df_pts.sample(frac=downsample_frac, replace=False,
                           random_state=seed)
    rng = np.random.default_rng(seed)
    shell = center.to_numpy() + radius * rng.standard_normal(
        (num_shell_points, 3))
    df_pts = pd.concat(
        [df_pts, pd.DataFrame(shell, columns=["x", "y", "z"])]
    )
    df_pts.to_parquet(os.path.join(output_dir, "point_cloud_downsample.parquet"))

    records = []
    for v in views:
        s = sensors[v.sensor_id]
        records.append({
            "image_path": v.path,
            "T_pointcloud_camera": v.T_pointcloud_camera.tolist(),
            "camera_intrinsics": s["K"].tolist(),
            "camera_height": s["height"],
            "camera_width": s["width"],
            "camera_id": v.sensor_id,
        })
    df = pd.DataFrame(records)
    is_train = df.index % 3 == 0
    train_df = df[is_train]
    val_df = df[~is_train]
    train_df.to_json(os.path.join(output_dir, "kitti_train.json"),
                     orient="records")
    val_df.to_json(os.path.join(output_dir, "kitti_val.json"),
                   orient="records")
    val_df.sample(frac=0.1, replace=False, random_state=seed).to_json(
        os.path.join(output_dir, "kitti_val_downsample.json"),
        orient="records",
    )
    print(f"{len(train_df)} train / {len(val_df)} val views, "
          f"{len(df_pts)} points -> {output_dir}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--camera_xml", type=str, required=True,
                        help="Agisoft chunk XML with cameras + sensors")
    parser.add_argument("--point_cloud_ply", type=str, required=True)
    parser.add_argument("--image_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    args = parser.parse_args()
    convert(args.camera_xml, args.point_cloud_ply, args.image_dir,
            args.output_dir)


if __name__ == "__main__":
    main()
