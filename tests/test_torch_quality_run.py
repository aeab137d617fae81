"""The port's quality gate (``tools/quality_run.py``) against the JAX
package's ``scripts/quality_run.py`` on the CPU: (a) the GT scene and the
ring cameras equal the JAX script's arrays, at the default and the
reference-regime parameters, with the generator left in the same state;
(b) a small GT (200 points, 4 views of 64 px) rendered by both packages
(the JAX side in interpret mode, the port through its plain versions):
rgb within 1e-4, and 8-bit images (truncated, as the scripts save them)
at most one level apart, only where the JAX value lies within 1e-4 of a
k/255 boundary; (c) both scripts' ``main()`` on the same arguments, with
the small scene and a trainer stub, in the default, ``--long`` and
``--reference_regime`` presets (the last two with zero GT frames from
render stubs): the same train/val records (perturbed poses included), the
same parquet, PNGs within (b)'s rule, the same GT render config and the
same trainer config field by field; (d) a 30-iteration run of the port on the CPU and a
second call that keeps the dataset and resumes from
``checkpoint_latest``. For (d) the validation interval is cut to 10 (the
script's is at least 250), so that a 30-iteration run validates and
checkpoints."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr
from taichi_3d_gaussian_splatting_tpu.ops.transforms import se3_to_qt
from taichi_3d_gaussian_splatting_tpu.training import trainer as jax_trainer
from taichi_3d_gaussian_splatting_tpu_torch.tools import quality_run as qr

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"n_clusters": 4, "pts_per_cluster": 50}
REFERENCE = {"n_clusters": 2000, "pts_per_cluster": 220, "spread": 2.6,
             "scale_range": (-4.8, -3.6), "color_noise": 0.5}


@pytest.fixture(scope="module")
def jq():
    """scripts/quality_run.py as a module. Importing it points JAX's
    persistent compilation cache at the repo's .jax_cache_bench; the
    settings in force before are restored."""
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    spec = importlib.util.spec_from_file_location(
        "jax_quality_run", ROOT / "scripts" / "quality_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])
    return mod


@pytest.fixture(scope="module")
def small_scene(jq):
    return jq.make_gt_scene(np.random.default_rng(0), **SMALL)


@pytest.fixture(scope="module")
def jax_frames(small_scene):
    """The JAX script's GT render of the small scene at 64x64 (its
    ``render_gt``, in interpret mode): cams -> clipped rgb frames."""
    xyz, feats = small_scene
    rcfg = jr.RasterizerConfig(tile_size=32, key_cap=2 ** 19, interpret=True)
    camera = jr.Camera(K=jnp.asarray(qr.ring_cameras(1, hw=64)[0][1]),
                       width=64, height=64)
    invalid = jnp.zeros((xyz.shape[0],), bool)

    @jax.jit
    def render_gt(q, t):
        return jnp.clip(jr.rasterize(
            jnp.asarray(xyz), jnp.asarray(feats), invalid, q, t, camera,
            rcfg).rgb, 0, 1)

    def frames(cams):
        return [np.asarray(render_gt(*se3_to_qt(jnp.asarray(T))))
                for T, _ in cams]
    return frames


def off_levels(jax_rgb, jax_u8, port_u8) -> int:
    """(b)'s rule for 8-bit frames: at most one level apart, and only where
    the JAX value lies within 1e-4 of a k/255 boundary; the count of
    pixel channels that differ."""
    diff = port_u8.astype(np.int32) - jax_u8.astype(np.int32)
    assert np.abs(diff).max() <= 1
    scaled = jax_rgb.astype(np.float64) * 255
    near = np.abs(scaled - np.rint(scaled)) <= 1e-4 * 255
    assert near[diff != 0].all()
    return int((diff != 0).sum())


@pytest.mark.parametrize("kw, cams", [
    ({}, {"n": 48, "hw": 256}),
    (REFERENCE, {"n": 128, "hw": 512, "w": 896}),
])
def test_scene_and_cameras_equal_the_jax_scripts(jq, kw, cams):
    rng_j, rng_p = np.random.default_rng(0), np.random.default_rng(0)
    for a, b in zip(jq.make_gt_scene(rng_j, **kw),
                    qr.make_gt_scene(rng_p, **kw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the later draws (pose noise, init selection) start from one state
    assert rng_j.bit_generator.state == rng_p.bit_generator.state
    for (tj, kj), (tp, kp) in zip(jq.ring_cameras(**cams),
                                  qr.ring_cameras(**cams)):
        assert np.array_equal(tj, tp) and np.array_equal(kj, kp)
        assert tj.dtype == tp.dtype and kj.dtype == kp.dtype


def test_small_gt_render_matches_jax(small_scene, jax_frames):
    xyz, feats = small_scene
    cams = qr.ring_cameras(4, hw=64)
    want = jax_frames(cams)
    got, keys = qr.render_views(xyz, feats, cams, 64, 64, 2 ** 19,
                                torch.device("cpu"))
    assert len(got) == 4 and all(k > 0 for k in keys)
    off = 0
    for j, p in zip(want, got):
        assert p.shape == (64, 64, 3) and p.dtype == np.float32
        assert float(j.max()) > 0.1  # the views see the scene
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-4)
        off += off_levels(j, (j * 255).astype(np.uint8),
                          (p * 255).astype(np.uint8))
    print(f"8-bit levels off by one: {off} of {4 * 64 * 64 * 3}")


class StubTrainer:
    """Records the config it is built with; train() returns at once (with
    the attributes the port's ``Watch`` wraps)."""

    configs = []
    device = torch.device("cpu")
    _capped = False

    def _scalar(self, tag, value, iteration):
        pass

    def _get_step(self, h, w, scan_steps=0):
        raise AssertionError("the stub trains nothing")

    def _maybe_rebucket_key_cap(self, num_keys):
        return False

    def __init__(self, config, device=None):
        self.configs.append(config)
        self.best_psnr_score = 0.0

    def train(self):
        return types.SimpleNamespace(
            scene=types.SimpleNamespace(num_valid=lambda: 0))


def normalized(value, out: str):
    """``value`` with the ``out`` directory replaced by a placeholder."""
    if isinstance(value, dict):
        return {k: normalized(v, out) for k, v in value.items()}
    if isinstance(value, list):
        return [normalized(v, out) for v in value]
    if isinstance(value, str):
        return value.replace(out, "<out>")
    return value


@pytest.mark.parametrize("preset", [[], ["--long"], ["--reference_regime"]],
                         ids=["default", "long", "reference_regime"])
def test_main_writes_the_jax_scripts_dataset_and_config(
        jq, jax_frames, tmp_path, monkeypatch, preset):
    """The default preset renders the small GT in both packages; the two
    that force 512 px get zero frames from stubs of the JAX script's
    ``rasterize`` and the port's ``render_views`` (each records the render
    config it was given), so that their records, parquet and configs are
    compared without a 512-px render."""
    argv = ["--views", "8", "--hw", "64", "--pose_noise", "0.01", *preset]
    outs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    StubTrainer.configs = []
    for mod in (jq, qr):
        orig = mod.make_gt_scene
        monkeypatch.setattr(mod, "make_gt_scene",
                            lambda rng, orig=orig, **kw: orig(rng, **SMALL))
    monkeypatch.setattr(jax_trainer, "GaussianPointCloudTrainer",
                        StubTrainer)
    rendered = {}
    if preset:
        def jax_rasterize(xyz, feats, invalid, q, t, camera, rcfg):
            rendered["jax"] = (rcfg.tile_size, rcfg.key_cap,
                               camera.height, camera.width)
            return types.SimpleNamespace(rgb=jnp.zeros(
                (camera.height, camera.width, 3), jnp.float32))

        def port_render(xyz, feats, cams, height, width, key_cap, dev):
            rendered["port"] = (32, key_cap, height, width)
            return ([np.zeros((height, width, 3), np.float32) for _ in cams],
                    [0] * len(cams))
        monkeypatch.setattr(jr, "rasterize", jax_rasterize)
        monkeypatch.setattr(qr, "render_views", port_render)
    monkeypatch.setattr(sys, "argv",
                        ["quality_run.py", *argv, "--out", outs["jax"]])
    jq.main()
    qr.main([*argv, "--out", outs["port"], "--device", "cpu"],
            trainer_class=StubTrainer)

    args = qr.parse_args(argv)
    if preset:
        assert rendered["jax"] == rendered["port"] == (
            32, 2 ** 21 if args.reference_regime else 2 ** 19,
            args.hw, args.width)

    def read(name):
        return {k: json.loads(Path(o, name).read_text())
                for k, o in outs.items()}
    for name in ("train.json", "val.json"):
        recs = read(name)
        assert len(recs["jax"]) == (7 if name == "train.json" else 1)
        assert normalized(recs["jax"], outs["jax"]) == normalized(
            recs["port"], outs["port"])
    # the train poses are perturbed, the val poses are the ring's
    cams = qr.ring_cameras(8, hw=args.hw, w=args.width)
    assert read("train.json")["port"][0]["T_pointcloud_camera"] != \
        cams[1][0].tolist()
    assert read("val.json")["port"][0]["T_pointcloud_camera"] == \
        cams[0][0].tolist()
    assert read("val.json")["port"][0]["camera_width"] == args.width

    frames = [pd.read_parquet(Path(o, "point_cloud.parquet"))
              for o in outs.values()]
    assert list(frames[0].columns) == list(frames[1].columns)
    assert len(frames[0]) == 25
    pd.testing.assert_frame_equal(frames[0], frames[1], check_exact=True)

    want = (jax_frames(cams) if not preset else
            [np.zeros((args.hw, args.width, 3), np.float32)] * len(cams))
    off = 0
    for i, rgb in enumerate(want):
        j, p = (np.asarray(Image.open(Path(o, "imgs", f"{i:03d}.png")))
                for o in outs.values())
        assert j.shape == p.shape == (args.hw, args.width, 3)
        assert np.array_equal(j, (rgb * 255).astype(np.uint8))
        off += off_levels(rgb, j, p)
    print(f"PNG levels off by one: {off} of {j.size * len(want)}")

    cfg_j, cfg_p = StubTrainer.configs
    assert normalized(dataclasses.asdict(cfg_j), outs["jax"]) == normalized(
        dataclasses.asdict(cfg_p), outs["port"])
    assert cfg_p.num_iterations == args.iterations
    assert cfg_p.pose_refinement and cfg_p.rasterisation_config.interpret
    assert cfg_p.steps_per_dispatch == (20 if args.reference_regime else 10)
    assert cfg_p.gaussian_point_cloud_scene_config.add_sphere == bool(preset)


@pytest.fixture
def small_port(monkeypatch):
    """The port's script with the small scene and validation every 10
    iterations."""
    orig_scene, orig_cfg = qr.make_gt_scene, qr.config_dict
    monkeypatch.setattr(qr, "make_gt_scene",
                        lambda rng: orig_scene(rng, **SMALL))
    monkeypatch.setattr(qr, "config_dict",
                        lambda args: dict(orig_cfg(args), val_interval=10))


def run_port(argv):
    """The port's main(); (record, stdout lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = qr.main(argv)
    return rec, buf.getvalue().splitlines()


def test_tiny_run_on_the_cpu_trains_and_resumes(tmp_path, small_port):
    argv = ["--views", "8", "--hw", "64", "--iterations", "30",
            "--out", str(tmp_path), "--device", "cpu"]
    rec, lines = run_port(argv)
    assert lines[-3].startswith("trained 30 iters in ")
    assert lines[-2] == f"final num_valid_points: {rec['final_valid_points']}"
    assert lines[-1] == f"best val PSNR: {rec['best_val_psnr']:.3f}"
    assert "dataset: 7 train / 1 val views, 25 init points" in lines
    assert sorted(rec["val_psnr"]) == [10, 20]
    assert any(line.startswith("val PSNR @ 20: ") for line in lines)
    assert rec["best_val_psnr"] == max(rec["val_psnr"].values()) > 5.0
    assert rec["steps_run"] == 30 and rec["windows"] == 2
    assert rec["captures"] == rec["replays"] == 0  # eager on the CPU
    assert rec["graphs_held"] == [0]
    assert rec["nonfinite_losses"] == 0 and rec["steps_past_key_cap"] == 0
    assert rec["final_valid_points"] == 25
    assert (tmp_path / "logs" / "checkpoint_latest").exists()

    rec2, lines2 = run_port(argv)
    assert "dataset exists, skipping GT render" in lines2
    assert not any(line.startswith("dataset: ") for line in lines2)
    assert any(line.startswith("resumed from ") and
               line.endswith("at iteration 21") for line in lines2)
    assert rec2["steps_run"] == 9
    assert lines2[-3].startswith("trained 30 iters in ")
    assert lines2[-1] == f"best val PSNR: {rec2['best_val_psnr']:.3f}"
    # both trainers checkpoint the best PSNR of the validations before the
    # checkpoint's own (iteration 10's here), and 21-29 hold none
    assert rec2["best_val_psnr"] == pytest.approx(rec["val_psnr"][10])
    assert bool(torch.isfinite(rec2["state"].scene.features).all())


def test_the_cuda_default_fails_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        qr.main(["--out", str(tmp_path)])
    assert not (tmp_path / "train.json").exists()
    assert qr.parse_args([]).device == "cuda"
