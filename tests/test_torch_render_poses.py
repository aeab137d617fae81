"""The port's dataset-pose rendering (``apps/render.py``
``poses_from_dataset``, the .json branch of its CLI and ``--gt_prefix``)
and ``apps/parquet_to_ply.py`` against the JAX package's, on a PNG
dataset and a parquet written in tmp_path: poses, intrinsics and image
sizes exactly, the ground-truth PNGs and the .ply files byte for byte."""
import json

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("pandas")
from PIL import Image  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.apps import parquet_to_ply as jp2p  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.apps import render as jrender  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.models import scene as jscene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.apps import parquet_to_ply as tp2p  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.apps import render as trender  # noqa: E402
from tests.test_torch_dataset import _pose  # noqa: E402
from tests.torch_port_scenes import make_scene  # noqa: E402


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Four views (the last 70x100, cropped to 64x96 and with its own
    intrinsics) and a trained-scene parquet of 150 points."""
    tmp = tmp_path_factory.mktemp("posedata")
    rng = np.random.default_rng(3)
    records = []
    for i, (h, w) in enumerate([(64, 64), (64, 64), (64, 64), (70, 100)]):
        arr = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        Image.fromarray(arr).save(tmp / f"{i}.png")
        K = [[60.0 + i, 0.0, w / 2], [0.0, 62.0, h / 2], [0.0, 0.0, 1.0]]
        records.append({"image_path": str(tmp / f"{i}.png"),
                        "T_pointcloud_camera": _pose(i).tolist(),
                        "camera_intrinsics": K, "camera_height": h,
                        "camera_width": w, "camera_id": 0})
    (tmp / "views.json").write_text(json.dumps(records))
    xyz, feats, _ = make_scene(150, seed=5)
    scene = jscene.create_scene(xyz, jscene.SceneConfig(), features=feats)
    jscene.to_parquet(scene, str(tmp / "scene.parquet"))
    return tmp


@pytest.mark.parametrize("with_gt", [False, True])
def test_poses_from_dataset_match_jax(data, tmp_path, with_gt):
    gt_t = gt_j = None
    if with_gt:
        gt_t, gt_j = tmp_path / "t", tmp_path / "j"
        gt_t.mkdir()
        gt_j.mkdir()
    got, info = trender.poses_from_dataset(str(data / "views.json"), gt_t)
    want, jinfo = jrender.poses_from_dataset(str(data / "views.json"), gt_j)
    assert got.shape == (4, 4, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (info.camera_height, info.camera_width) == (64, 96)
    assert (info.camera_height, info.camera_width, info.camera_id) == (
        jinfo.camera_height, jinfo.camera_width, jinfo.camera_id)
    np.testing.assert_array_equal(info.camera_intrinsics,
                                  jinfo.camera_intrinsics)
    if with_gt:
        names = sorted(p.name for p in gt_t.iterdir())
        assert names == sorted(p.name for p in gt_j.iterdir()) == [
            f"frame_{i:03}.png" for i in range(4)]
        for n in names:
            assert (gt_t / n).read_bytes() == (gt_j / n).read_bytes()
        # every decoded pose is its record's rotation, up to f32 rounding
        for i in range(4):
            np.testing.assert_allclose(got[i], _pose(i), atol=1e-6)


def test_render_cli_with_dataset_poses(data, tmp_path):
    out, gt = tmp_path / "frames", tmp_path / "gt"
    trender.main(["--parquet_path", str(data / "scene.parquet"),
                  "--poses", str(data / "views.json"), "--output_prefix",
                  str(out), "--gt_prefix", str(gt), "--device", "cpu"])
    names = [f"frame_{i:03}.png" for i in range(4)]
    assert sorted(p.name for p in out.iterdir()) == names
    assert sorted(p.name for p in gt.iterdir()) == names
    frame = np.asarray(Image.open(out / "frame_000.png"))
    assert frame.shape == (64, 96, 3) and frame.max() > 0
    with pytest.raises(ValueError, match=".pt or .json"):
        trender.main(["--parquet_path", str(data / "scene.parquet"),
                      "--poses", str(data / "poses.csv"),
                      "--output_prefix", str(out), "--device", "cpu"])


def test_parquet_to_ply_bytes_match_jax(data, tmp_path, monkeypatch):
    tp2p.main(["--parquet_path", str(data / "scene.parquet"),
               "--ply_path", str(tmp_path / "port.ply")])
    monkeypatch.setattr("sys.argv", [
        "parquet_to_ply", "--parquet_path", str(data / "scene.parquet"),
        "--ply_path", str(tmp_path / "jax.ply")])
    jp2p.main()
    got = (tmp_path / "port.ply").read_bytes()
    assert got == (tmp_path / "jax.ply").read_bytes()
    assert got.startswith(b"ply") and len(got) > 150 * 59 * 4
