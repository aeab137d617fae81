"""The port's dataset-prep tools (``taichi_3d_gaussian_splatting_tpu_torch/
tools``) against their JAX-package twins on synthetic inputs in
``tmp_path``: each tool runs on the same input twice, once per package,
and the outputs must be equal (JSON records, parquet tables, YAML, arrays:
exact). Then the port's own COLMAP -> ``train()`` -> ``apps.render``
pipeline on the CPU (tests/test_ingestion_pipeline.py:63 for the JAX
package).
"""
import json
import os
import struct
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from tests.test_ingestion_pipeline import colmap_model  # noqa: F401,E402
from taichi_3d_gaussian_splatting_tpu.tools import (  # noqa: E402
    generate_ellipse_path as jellipse,
    ply_io as jply,
    prepare_colmap as jcolmap,
    prepare_instant_ngp as jngp,
    prepare_kitti as jkitti,
)
from taichi_3d_gaussian_splatting_tpu_torch.tools import (  # noqa: E402
    generate_ellipse_path as tellipse,
    ply_io as tply,
    prepare_colmap as tcolmap,
    prepare_instant_ngp as tngp,
    prepare_kitti as tkitti,
)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_dirs(dj, dt):
    import pandas as pd

    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and names
    for name in names:
        pj, pt = os.path.join(dj, name), os.path.join(dt, name)
        if name.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(pj),
                                          pd.read_parquet(pt))
        elif name.endswith(".json"):
            with open(pj) as fj, open(pt) as ft:
                _same_tree(json.load(fj), json.load(ft))
        else:
            with open(pj, "rb") as fj, open(pt, "rb") as ft:
                assert fj.read() == ft.read(), name


def _mesh(rng):
    verts = rng.normal(size=(12, 3))
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7], [8, 9, 10, 11, 0]]
    return verts, faces


def _write_ascii_ply(path, verts, faces):
    lines = ["ply", "format ascii 1.0", "comment synthetic",
             f"element vertex {len(verts)}", "property float x",
             "property float y", "property float z", "property uchar red",
             f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {i % 256}"
              for i, v in enumerate(verts)]
    lines += [" ".join(str(x) for x in [len(f)] + list(f)) for f in faces]
    path.write_text("\n".join(lines) + "\n")


def _write_binary_ply(path, verts, faces):
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(verts)}", "property float x",
              "property float y", "property float z", "property double w",
              "property int label", f"element face {len(faces)}",
              "property list uchar int vertex_indices", "end_header"]
    body = b"".join(struct.pack("<fffdi", *v, float(v[0]) * 2, i)
                    for i, v in enumerate(verts))
    body += b"".join(struct.pack(f"<B{len(f)}i", len(f), *f) for f in faces)
    path.write_bytes(("\n".join(header) + "\n").encode() + body)


def _write_obj(path, verts, faces):
    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += ["f " + " ".join(f"{i + 1}/{i + 1}" for i in f) for f in faces]
    path.write_text("# synthetic\n" + "\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["ascii", "binary", "obj"])
def test_ply_io_matches_jax(kind, tmp_path):
    verts, faces = _mesh(np.random.default_rng(1))
    path = tmp_path / ("mesh.obj" if kind == "obj" else "mesh.ply")
    {"ascii": _write_ascii_ply, "binary": _write_binary_ply,
     "obj": _write_obj}[kind](path, verts, faces)
    if kind != "obj":
        _same_tree(tply.read_ply(str(path)), jply.read_ply(str(path)))
        _same_tree(tply.read_ply_points(str(path)),
                   jply.read_ply_points(str(path)))
    vt, ft = tply.read_mesh(str(path))
    vj, fj = jply.read_mesh(str(path))
    _same_tree((vt, ft), (vj, fj))
    # fan-triangulated: a polygon of k vertices gives k - 2 triangles
    assert ft.shape == (sum(len(f) - 2 for f in faces), 3)
    pt = tply.sample_mesh_surface(vt, ft, 300, np.random.default_rng(5))
    pj = jply.sample_mesh_surface(vj, fj, 300, np.random.default_rng(5))
    np.testing.assert_array_equal(pt, pj)
    assert pt.dtype == np.float32 and pt.shape == (300, 3)


def _colmap_binary(root, text_sparse):
    """The text model of the ingestion fixture written as COLMAP .bin files
    (PINHOLE camera, 2D observations and tracks included)."""
    out = root / "sparse_bin"
    out.mkdir()
    cams = jcolmap.read_cameras_txt(os.path.join(text_sparse, "cameras.txt"))
    images = jcolmap.read_images_txt(os.path.join(text_sparse, "images.txt"))
    xyz, rgb = jcolmap.read_points3d_txt(
        os.path.join(text_sparse, "points3D.txt"))
    with open(out / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            f.write(struct.pack("<iiQQ", cid, 1, c["width"], c["height"]))
            p = c["params"]  # SIMPLE_PINHOLE -> PINHOLE (fx = fy)
            f.write(struct.pack("<4d", p[0], p[0] * 1.01, p[1], p[2]))
    with open(out / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for i, (name, im) in enumerate(sorted(images.items())):
            f.write(struct.pack("<idddddddi", i + 1, *im["qvec"],
                                *im["tvec"], im["camera_id"]))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2) + struct.pack("<ddq", 1, 2, -1) * 2)
    with open(out / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, *c.tolist(), 0.5))
            f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))
    return str(out)


@pytest.mark.parametrize("model", ["text", "binary", "test_list"])
def test_prepare_colmap_matches_jax(colmap_model, model, tmp_path):  # noqa: F811
    root, sparse, images_dir = colmap_model
    test_list = None
    if model == "binary":
        sparse = _colmap_binary(root, sparse)
    elif model == "test_list":
        test_list = str(tmp_path / "test.txt")
        with open(test_list, "w") as f:
            f.write("frame_002.png\nframe_005.png\n")
    tcolmap.convert(sparse, images_dir, str(tmp_path / "t"), test_list)
    jcolmap.convert(sparse, images_dir, str(tmp_path / "j"), test_list)
    _same_dirs(tmp_path / "j", tmp_path / "t")
    val = json.loads((tmp_path / "t" / "val.json").read_text())
    assert len(val) == 2


def _transforms(rng, n=9, per_frame_k=False):
    frames = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = rng.normal(size=3)
        frame = {"file_path": f"images/{i:03d}.png",
                 "transform_matrix": T.tolist()}
        if per_frame_k and i % 2:
            frame.update(fl_x=50.0 + i, fl_y=51.0, cx=31.5, cy=30.5, w=64,
                         h=62)
        frames.append(frame)
    return {"fl_x": 60.0, "fl_y": 61.0, "cx": 32.0, "cy": 31.0, "w": 64,
            "h": 64, "frames": frames}


@pytest.mark.parametrize("with_test", [False, True])
def test_prepare_instant_ngp_matches_jax(with_test, tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    tj = _transforms(rng, per_frame_k=True)
    _same_tree(tngp.convert_transforms(tj, "data"),
               jngp.convert_transforms(tj, "data"))
    (tmp_path / "train.json").write_text(json.dumps(tj))
    (tmp_path / "test.json").write_text(json.dumps(_transforms(rng, 3)))
    verts, faces = _mesh(rng)
    _write_ascii_ply(tmp_path / "mesh.ply", verts, faces)
    for name, mod in (("t", tngp), ("j", jngp)):
        argv = ["prepare", "--transforms_train", str(tmp_path / "train.json"),
                "--mesh_path", str(tmp_path / "mesh.ply"),
                "--mesh_sample_points", "200", "--image_path_prefix", "p",
                "--output_path", str(tmp_path / name)]
        if with_test:
            argv += ["--transforms_test", str(tmp_path / "test.json")]
        monkeypatch.setattr(sys, "argv", argv)
        mod.main()
    _same_dirs(tmp_path / "j", tmp_path / "t")


def test_prepare_kitti_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    cams = []
    for i in range(7):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        text = " ".join(f"{x:.6f}" for x in T.ravel())
        sensor = "0" if i % 2 else "1"
        tr = f"<transform>{text}</transform>" if i != 4 else ""
        cams.append(f'<camera id="{i}" label="img_{6 - i:02d}" '
                    f'sensor_id="{sensor}">{tr}</camera>')
    sensors = "".join(
        f'<sensor id="{s}"><calibration><resolution width="{w}" '
        f'height="{h}"/><f>{f}</f></calibration></sensor>'
        for s, w, h, f in (("0", 1242, 375, 721.5), ("1", 1224, 370, 707.0)))
    (tmp_path / "cams.xml").write_text(
        f"<document><chunk><sensors>{sensors}</sensors><cameras>"
        f"{''.join(cams)}</cameras></chunk></document>")
    verts = rng.normal(size=(500, 3)) * 10
    _write_binary_ply(tmp_path / "lidar.ply", verts, [[0, 1, 2]])
    for name, mod in (("t", tkitti), ("j", jkitti)):
        mod.convert(str(tmp_path / "cams.xml"), str(tmp_path / "lidar.ply"),
                    str(tmp_path / "imgs"), str(tmp_path / name),
                    downsample_frac=0.1, num_shell_points=50)
    _same_dirs(tmp_path / "j", tmp_path / "t")


def test_prepare_config_matches_jax(tmp_path, monkeypatch):
    import yaml

    from taichi_3d_gaussian_splatting_tpu.tools import prepare_config as jcfg
    from taichi_3d_gaussian_splatting_tpu_torch.tools import (
        prepare_config as tcfg,
    )

    (tmp_path / "example.yaml").write_text(yaml.safe_dump(
        {"num-iterations": 30000, "rasterisation-config": {"tile-size": 32},
         "train-dataset-json-path": "old"}))
    for name, mod in (("t", tcfg), ("j", jcfg)):
        monkeypatch.setattr(sys, "argv", [
            "prepare", "--example_config", str(tmp_path / "example.yaml"),
            "--input_prefix", str(tmp_path / "data"),
            "--output", str(tmp_path / f"{name}.yaml")])
        mod.main()
    assert ((tmp_path / "t.yaml").read_text()
            == (tmp_path / "j.yaml").read_text())
    assert yaml.safe_load((tmp_path / "t.yaml").read_text())[
        "train-dataset-json-path"] == str(tmp_path / "data" / "train.json")


@pytest.mark.parametrize("method", ["up", "pca", "vertical", "none"])
def test_ellipse_path_matches_jax(method):
    rng = np.random.default_rng(6)
    cams = []
    for i in range(12):
        a = 2 * np.pi * i / 12
        T = np.eye(4)
        T[:3, 3] = [3 * np.cos(a), 0.3 * rng.normal(), 2 * np.sin(a)]
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        cams.append({"T_pointcloud_camera": T.tolist()})
    got = tellipse.ellipse_path_from_dataset(cams, 24, method)
    want = jellipse.ellipse_path_from_dataset(cams, 24, method)
    assert got.shape == (24, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_ellipse_path_cli_saves_poses(tmp_path, monkeypatch):
    import torch

    cams = [{"T_pointcloud_camera": np.eye(4).tolist()}]
    for i in range(1, 6):
        T = np.eye(4)
        T[:3, 3] = [np.cos(i), 0.1 * i, np.sin(i)]
        cams.append({"T_pointcloud_camera": T.tolist()})
    (tmp_path / "train.json").write_text(json.dumps(cams))
    monkeypatch.setattr(sys, "argv", [
        "ellipse", "--cameras", str(tmp_path / "train.json"),
        "--n_frames", "8", "--output", str(tmp_path / "path.pt")])
    tellipse.main()
    poses = torch.load(tmp_path / "path.pt", weights_only=True).numpy()
    np.testing.assert_array_equal(
        poses, jellipse.ellipse_path_from_dataset(cams, 8))


def test_colmap_to_train_to_render(colmap_model, tmp_path):  # noqa: F811
    """COLMAP text model -> the port's convert -> train() on the CPU -> the
    port's render CLI with GT frames."""
    from PIL import Image

    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        GaussianPointCloudTrainer,
    )

    root, sparse, images_dir = colmap_model
    out = root / "dataset"
    tcolmap.convert(sparse, images_dir, str(out))
    train_recs = json.loads((out / "train.json").read_text())
    val_recs = json.loads((out / "val.json").read_text())
    assert len(train_recs) == 7 and len(val_recs) == 2
    T = np.asarray(train_recs[0]["T_pointcloud_camera"])
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=1e-6)

    logs = root / "logs"
    config = from_dict({
        "train_dataset_json_path": str(out / "train.json"),
        "val_dataset_json_path": str(out / "val.json"),
        "pointcloud_parquet_path": str(out / "point_cloud.parquet"),
        "summary_writer_log_dir": str(logs),
        "num_iterations": 4, "val_interval": 3,
        "initial_downsample_factor": 1,
        "rasterisation_config": {"tile_size": 32},
        "loss_function_config": {"enable_regularization": False},
        "adaptive_controller_config": {"num_iterations_warm_up": 100},
    })
    state = GaussianPointCloudTrainer(config, device="cpu").train()
    assert np.isfinite(state.scene.features.numpy()).all()
    ckpt = logs / "scene_3.parquet"
    assert ckpt.exists()

    frames, gts = root / "frames", root / "gt"
    render.main(["--parquet_path", str(ckpt), "--poses",
                 str(out / "val.json"), "--output_prefix", str(frames),
                 "--gt_prefix", str(gts), "--device", "cpu"])
    assert len(os.listdir(gts)) == len(val_recs)
    names = sorted(os.listdir(frames))
    assert len(names) == len(val_recs)
    img = np.asarray(Image.open(frames / names[0]))
    assert img.shape == (64, 64, 3) and img.max() > 0
