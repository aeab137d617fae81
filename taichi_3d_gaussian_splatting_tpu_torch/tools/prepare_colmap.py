"""COLMAP text/binary model -> train.json / val.json / point_cloud.parquet.

Port of
``taichi_3d_gaussian_splatting_tpu/tools/prepare_colmap.py``,
a copy that runs on the host alone (no device, no torch).

Behavioral reference: tools/prepare_colmap.py. Same outputs:
- dataset records {image_path, T_pointcloud_camera, camera_intrinsics,
  camera_height, camera_width, camera_id} where T_pointcloud_camera =
  inv([R(q) | t]) of the COLMAP world->camera pose (:262-268),
- every-8th-frame validation split unless a test-image list is given (:312),
- point_cloud.parquet with x, y, z, r, g, b columns.

Supports SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL intrinsics
(distortion coefficients are dropped, like the reference :62-87).
"""
from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params); full COLMAP table
COLMAP_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def intrinsics_from_params(model: str, params) -> np.ndarray:
    p = list(params)
    if model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                 "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        f, cx, cy = p[0], p[1], p[2]
        return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)
    if model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV",
                 "THIN_PRISM_FISHEYE"):
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    raise ValueError(f"unsupported COLMAP camera model {model}")


def _read(fid, nbytes, fmt):
    return struct.unpack("<" + fmt, fid.read(nbytes))


def read_cameras_txt(path: str) -> Dict[int, dict]:
    cameras = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.split()
            cid = int(fields[0])
            cameras[cid] = {
                "model": fields[1],
                "width": int(fields[2]),
                "height": int(fields[3]),
                "params": [float(x) for x in fields[4:]],
            }
    return cameras


def read_cameras_binary(path: str) -> Dict[int, dict]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, width, height = _read(f, 24, "iiQQ")
            name, n_params = COLMAP_CAMERA_MODELS[model_id]
            params = _read(f, 8 * n_params, "d" * n_params)
            cameras[cid] = {
                "model": name, "width": int(width), "height": int(height),
                "params": list(params),
            }
    return cameras


def read_images_txt(path: str) -> Dict[str, dict]:
    images = {}
    with open(path) as f:
        # drop comments AND blank lines: a stray blank would shift the
        # meta/observations two-line pairing
        lines = [ln for ln in f if ln.strip() and not ln.startswith("#")]
    # pairs of lines: meta, then 2D observations (ignored); a trailing
    # meta line without observations still counts
    for i in range(0, len(lines), 2):
        fields = lines[i].split()
        if len(fields) < 10:
            raise ValueError(
                f"malformed images.txt meta line {i}: {lines[i][:80]!r}")
        name = " ".join(fields[9:])
        images[name] = {
            "qvec": [float(x) for x in fields[1:5]],  # wxyz
            "tvec": [float(x) for x in fields[5:8]],
            "camera_id": int(fields[8]),
        }
    return images


def read_images_binary(path: str) -> Dict[str, dict]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 64, "idddddddi")
            qvec = list(props[1:5])
            tvec = list(props[5:8])
            camera_id = props[8]
            chars = []
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                chars.append(c)
            name = b"".join(chars).decode("utf-8")
            (n2d,) = _read(f, 8, "Q")
            f.read(24 * n2d)  # skip 2D points
            images[name] = {"qvec": qvec, "tvec": tvec,
                            "camera_id": camera_id}
    return images


def read_points3d_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            fields = line.split()
            xyz.append([float(x) for x in fields[1:4]])
            rgb.append([int(x) for x in fields[4:7]])
    return np.asarray(xyz, np.float64), np.asarray(rgb, np.uint8)


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            props = _read(f, 43, "QdddBBBd")
            xyz.append(props[1:4])
            rgb.append(props[4:7])
            (track_len,) = _read(f, 8, "Q")
            f.read(8 * track_len)
    return np.asarray(xyz, np.float64), np.asarray(rgb, np.uint8)


def quaternion_wxyz_to_rotation(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _load_model(base_path: str):
    def pick(stem_bin, stem_txt, rdr_bin, rdr_txt):
        for stem, rdr in ((stem_bin, rdr_bin), (stem_bin.lower(), rdr_bin),
                          (stem_txt, rdr_txt), (stem_txt.lower(), rdr_txt)):
            p = os.path.join(base_path, stem)
            if os.path.exists(p):
                return rdr(p)
        raise FileNotFoundError(f"{stem_bin}/{stem_txt} under {base_path}")

    images = pick("images.bin", "images.txt",
                  read_images_binary, read_images_txt)
    cameras = pick("cameras.bin", "cameras.txt",
                   read_cameras_binary, read_cameras_txt)
    points = pick("points3D.bin", "points3D.txt",
                  read_points3d_binary, read_points3d_txt)
    return images, cameras, points


def convert(base_path: str, image_path: str, output_dir: str,
            test_image_list_path: str | None = None) -> None:
    import pandas as pd

    images, cameras, (xyz, rgb) = _load_model(base_path)

    records = []
    # sorted by image name: COLMAP stores registration order, which is
    # run-dependent — sorting keeps the every-8th split stable across
    # reconstructions and .bin/.txt conversions
    for name, image in sorted(images.items()):
        cam = cameras[int(image["camera_id"])]
        T_cam_world = np.eye(4)
        T_cam_world[:3, :3] = quaternion_wxyz_to_rotation(image["qvec"])
        T_cam_world[:3, 3] = image["tvec"]
        T_pointcloud_camera = np.linalg.inv(T_cam_world)
        K = intrinsics_from_params(cam["model"], cam["params"])
        records.append({
            "image_path": os.path.join(image_path, name),
            "T_pointcloud_camera": T_pointcloud_camera.tolist(),
            "camera_intrinsics": K.tolist(),
            "camera_height": cam["height"],
            "camera_width": cam["width"],
            "camera_id": int(image["camera_id"]),
        })

    if test_image_list_path:
        with open(test_image_list_path) as f:
            test_names = {ln.strip() for ln in f if ln.strip()}
        # match the COLMAP image name as written (may contain subdirs);
        # basename-only matching breaks nested names and collides
        # duplicates across subdirectories
        is_train = [
            name not in test_names
            and os.path.basename(name) not in test_names
            for name in sorted(images.keys())
        ]
    else:
        is_train = [i % 8 != 0 for i in range(len(records))]  # every 8th val

    train = [r for r, t in zip(records, is_train) if t]
    val = [r for r, t in zip(records, is_train) if not t]
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(output_dir, "val.json"), "w") as f:
        json.dump(val, f)

    df = pd.DataFrame({
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "r": rgb[:, 0], "g": rgb[:, 1], "b": rgb[:, 2],
    })
    df.to_parquet(os.path.join(output_dir, "point_cloud.parquet"))
    print(f"{len(train)} train / {len(val)} val views, "
          f"{xyz.shape[0]} points -> {output_dir}")


def main():
    parser = argparse.ArgumentParser(
        "Prepare a 3DGS dataset from COLMAP text/binary output")
    parser.add_argument("--base_path", type=str, required=True)
    parser.add_argument("--image_path", type=str, required=True)
    parser.add_argument("--test_image_list_path", type=str, default=None)
    parser.add_argument("--output_dir", type=str, required=True)
    args = parser.parse_args()
    convert(args.base_path, args.image_path, args.output_dir,
            args.test_image_list_path)


if __name__ == "__main__":
    main()
