"""The port's headless renderer and scene I/O against the JAX package's.

The renderer frames (uint8) agree within one level: the two blends differ
by at most 1e-4 before quantization. The scene file is a .ply written with
``to_ply``, so neither side needs pandas (the JAX renderer's parquet
loader is pointed at its own ``from_ply`` for the test).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.apps import render as jrender  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.models import scene as jscene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch import convert  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.apps import render as trender  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.models import scene as tscene  # noqa: E402
from tests.torch_port_scenes import make_K, make_scene  # noqa: E402


def _poses():
    """Two camera->world poses: identity, and a small turn plus a shift."""
    a = 0.08
    turn = np.eye(4, dtype=np.float32)
    turn[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]
    turn[:3, 3] = [0.1, -0.05, -0.3]
    return np.stack([np.eye(4, dtype=np.float32), turn])


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("render")
    xyz, feats, invalid = make_scene(150, seed=3)
    s = tscene.create_scene(xyz[~invalid], tscene.SceneConfig(),
                            features=feats[~invalid], device="cpu")
    tscene.to_ply(s, str(d / "scene.ply"))
    torch.save(torch.from_numpy(_poses()), d / "poses.pt")
    return d


def test_renderer_frames_match_jax(scene_files, monkeypatch):
    ply, pt = str(scene_files / "scene.ply"), str(scene_files / "poses.pt")
    kw = dict(parquet_paths=[ply], image_height=64, image_width=70,
              camera_intrinsics=make_K())
    monkeypatch.setattr(jrender.scene_lib, "from_parquet",
                        lambda path, config: jscene.from_ply(path, config))
    want = dict(jrender.GaussianPointRenderer(
        jrender.RendererConfig(**kw), jrender.load_poses_pt(pt)).frames())
    got = dict(trender.GaussianPointRenderer(
        trender.RendererConfig(**kw), trender.load_poses_pt(pt),
        device="cpu").frames())
    assert sorted(got) == sorted(want) == [0, 1]
    for i in got:
        assert got[i].shape == want[i].shape == (64, 64, 3)
        assert got[i].dtype == np.uint8 and got[i].max() > 0
        diff = np.abs(got[i].astype(np.int16) - want[i].astype(np.int16))
        assert diff.max() <= 1, (i, diff.max())


def test_render_cli_writes_frames(scene_files, tmp_path):
    out = tmp_path / "frames"
    trender.main(["--parquet_path", str(scene_files / "scene.ply"),
                  "--poses", str(scene_files / "poses.pt"),
                  "--output_prefix", str(out), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["frame_000.png",
                                                     "frame_001.png"]


@pytest.mark.parametrize("argv_extra, poses", [
    (["--data_parallel"], "poses.pt"), (["--tile_parallel"], "poses.pt")])
def test_render_cli_refuses_later_slices(scene_files, tmp_path, argv_extra,
                                         poses):
    """--data_parallel and --tile_parallel on one rank (the CPU, no
    process group) write the plain loop's frames. (The name is the one the
    test had when the port refused these flags; they now run.)"""
    frames = {}
    for name, extra in (("plain", []), ("flag", argv_extra)):
        out = tmp_path / name
        trender.main(["--parquet_path", str(scene_files / "scene.ply"),
                      "--poses", str(scene_files / poses),
                      "--output_prefix", str(out), "--device", "cpu"]
                     + extra)
        frames[name] = {p.name: p.read_bytes() for p in out.iterdir()}
    assert sorted(frames["flag"]) == ["frame_000.png", "frame_001.png"]
    assert frames["flag"] == frames["plain"]


def test_scene_io_matches_jax(scene_files, tmp_path):
    ply = str(scene_files / "scene.ply")
    j = jscene.from_ply(ply)
    t = tscene.from_ply(ply, device="cpu")
    for name in ("xyz", "features", "invalid", "object_id"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    # round trip through the port's own writer
    tscene.to_ply(t, str(tmp_path / "again.ply"))
    assert (tmp_path / "again.ply").read_bytes() == (
        scene_files / "scene.ply").read_bytes()
    merged = tscene.merge_scenes([t, t])
    jm = jscene.merge_scenes([j, j])
    np.testing.assert_array_equal(merged.object_id.numpy(),
                                  np.asarray(jm.object_id))
    assert merged.capacity == 2 * t.capacity


def test_create_scene_matches_jax():
    xyz, _, _ = make_scene(60, seed=9)
    rgb = np.random.default_rng(2).integers(0, 256, (60, 3))
    cfg = dict(max_num_points_ratio=1.5, max_initial_covariance=0.5)
    j = jscene.create_scene(xyz, jscene.SceneConfig(**cfg), rgb=rgb, seed=4)
    t = tscene.create_scene(xyz, tscene.SceneConfig(**cfg), rgb=rgb, seed=4,
                            device="cpu")
    for name in ("xyz", "features", "invalid", "object_id"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert int(t.num_valid()) == 60 and t.capacity == 90


def test_convert_jax_state():
    xyz, feats, invalid = make_scene(40, seed=1)
    j = jscene.create_scene(xyz, jscene.SceneConfig(), features=feats)
    s = convert.scene_from_jax_arrays(j.xyz, j.features, invalid,
                                      j.object_id, device="cpu")
    np.testing.assert_array_equal(s.features.numpy(), feats)
    assert s.invalid.dtype == torch.bool and s.object_id.dtype == torch.int32
    cam = convert.camera_from_jax(make_K(), 64, 48, device="cpu")
    assert cam.K.dtype == torch.float32 and (cam.width, cam.height) == (64, 48)
