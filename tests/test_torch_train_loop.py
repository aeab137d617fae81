"""The port's training loop (``GaussianPointCloudTrainer``) and its CLI on
the CPU, on a tiny PNG + parquet dataset: 8 iterations through both
downsample factors and SH bands 0-3, one densify round, one alpha reset
and one validation; the files it writes, a resume from its checkpoint, and
its per-iteration losses before warm-up against the JAX trainer's at the
train-step gates of tests/test_torch_train_step.py (loss, l1, ssim and
psnr at rtol 1e-4)."""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.apps import train as train_app
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint as ck
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
    TrainConfig,
    from_dict,
    load_config,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    GaussianPointCloudTrainer,
)
from tests.torch_port_scenes import make_K

ITERS = 8


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("dataset"))


def write_dataset(tmp):
    """Three 64x64 train views (a colour ramp with seeded noise, slightly
    moved cameras), one val view, and a 150-point parquet, in ``tmp``."""
    from PIL import Image
    import pandas as pd

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:64, 0:64] / 64
    records = []
    for i in range(3):
        img = np.stack([x, y, 0.5 * (x + y)], -1) + rng.normal(
            0, 0.05, (64, 64, 3))
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        path = tmp / f"{i}.png"
        Image.fromarray(arr).save(path)
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, -0.03 * i, 0.0]
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": T.tolist(),
                        "camera_intrinsics": make_K().tolist(),
                        "camera_height": 64, "camera_width": 64,
                        "camera_id": 0})
    (tmp / "train.json").write_text(json.dumps(records))
    (tmp / "val.json").write_text(json.dumps(records[1:2]))
    pts = np.stack([rng.uniform(-0.8, 0.8, 150), rng.uniform(-0.8, 0.8, 150),
                    rng.uniform(2.0, 4.0, 150)], axis=-1)
    pd.DataFrame(pts, columns=["x", "y", "z"]).to_parquet(
        tmp / "points.parquet")
    return tmp


def _config_dict(dataset, log_dir, **over):
    d = {
        "train_dataset_json_path": str(dataset / "train.json"),
        "val_dataset_json_path": str(dataset / "val.json"),
        "pointcloud_parquet_path": str(dataset / "points.parquet"),
        "num_iterations": ITERS, "val_interval": ITERS - 1,
        "initial_downsample_factor": 2, "half_downsample_factor_interval": 4,
        "increase_color_max_sh_band_interval": 2,
        "log_loss_interval": 1, "log_metrics_interval": 4,
        "log_image_interval": 4, "print_metrics_to_console": True,
        "summary_writer_log_dir": str(log_dir),
        "rasterisation_config": {"tile_size": 32},
        "adaptive_controller_config": {
            "num_iterations_warm_up": 4, "num_iterations_densify": 5,
            "num_iterations_reset_alpha": 6, "plot_densify_interval": 5,
            "densification_view_space_position_gradients_threshold": 1e-9,
            "under_reconstructed_num_pixels_threshold": 8,
        },
        "gaussian_point_cloud_scene_config": {"max_num_points_ratio": 1.5,
                                              "initial_alpha": 0.5},
    }
    d.update(over)
    return d


def _console(text: str, key: str):
    return [float(v) for v in re.findall(rf"^{key}=(.*);$", text, re.M)]


@pytest.fixture(scope="module")
def run(dataset, tmp_path_factory):
    """One run of the loop, with its densify rounds and alpha resets
    recorded."""
    log_dir = tmp_path_factory.mktemp("logs")
    trainer = GaussianPointCloudTrainer(
        from_dict(_config_dict(dataset, log_dir)), device="cpu")
    rounds, resets = [], []
    apply, reset = trainer.densify_apply, trainer.alpha_reset

    def densify_apply(scene, info, generator):
        new_scene, new_ctrl = apply(scene, info, generator)
        rounds.append((int(scene.num_valid()), int(new_scene.num_valid())))
        return new_scene, new_ctrl

    def alpha_reset(scene):
        resets.append(float(scene.features[:, 7].max()))
        return reset(scene)

    trainer.densify_apply, trainer.alpha_reset = densify_apply, alpha_reset
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = trainer.train()
    return trainer, state, out.getvalue(), log_dir, rounds, resets


def test_loop_trains_densifies_and_validates(run):
    trainer, state, text, log_dir, rounds, resets = run
    assert _console(text, "train_iteration") == list(range(ITERS))
    losses = _console(text, "train_loss")
    assert len(losses) == ITERS and np.isfinite(losses).all()
    # one densify round (iteration 5) that fills free slots
    assert len(rounds) == 1 and rounds[0][1] > rounds[0][0]
    assert len(resets) == 1 and resets[0] > 0.1  # iteration 6
    assert int(state.scene.num_valid()) == rounds[0][1]
    assert state.feat_opt.count == state.pos_opt.count == ITERS
    for name in ("scene_7.parquet", "best_scene.parquet",
                 "checkpoint_latest"):
        assert os.path.exists(log_dir / name), name
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(log_dir))
    assert len(_console(text, "val_psnr_7")) == 1
    assert trainer.best_psnr_score == _console(text, "val_psnr")[0]
    # the loop's two image sizes: 32x32 before iteration 4, 64x64 after
    assert sorted(trainer._step_cache) == [(32, 32), (64, 64)]


def test_scene_export_reads_back(run):
    import pandas as pd

    _, state, _, log_dir, _, _ = run
    df = pd.read_parquet(log_dir / "scene_7.parquet")
    valid = ~state.scene.invalid.numpy()
    assert len(df) == int(valid.sum())
    np.testing.assert_array_equal(df[["x", "y", "z"]].to_numpy(np.float32),
                                  state.scene.xyz.numpy()[valid])


def test_resume_restores_the_state(run, dataset, capsys):
    trainer, state, _, log_dir, _, _ = run
    path = str(log_dir / "checkpoint_latest")
    # resumed at the last iteration + 1 = num_iterations: nothing to run,
    # train() returns the restored state
    resumed = GaussianPointCloudTrainer(from_dict(_config_dict(
        dataset, log_dir / "resumed", resume_from=path)), device="cpu")
    restored = resumed.train()
    assert f"at iteration {ITERS}" in capsys.readouterr().out
    for a, b in zip(ck.state_leaves(restored), ck.state_leaves(state)):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    assert torch.equal(resumed.generator.get_state(),
                       trainer.generator.get_state())
    assert resumed.best_psnr_score == 0.0  # saved before this validation
    # two more iterations go on from there
    more = GaussianPointCloudTrainer(from_dict(_config_dict(
        dataset, log_dir / "more", resume_from=path,
        num_iterations=ITERS + 2)), device="cpu")
    state2 = more.train()
    text = capsys.readouterr().out
    assert _console(text, "train_iteration") == [ITERS, ITERS + 1]
    assert state2.feat_opt.count == ITERS + 2


def test_losses_before_warm_up_match_jax(dataset, tmp_path):
    """The same config through both trainers (both downsample factors);
    the losses each prints per iteration agree at the train-step gates."""
    pytest.importorskip("jax")
    from taichi_3d_gaussian_splatting_tpu.training.config import (
        from_dict as jax_from_dict,
    )
    from taichi_3d_gaussian_splatting_tpu.training.trainer import (
        GaussianPointCloudTrainer as JaxTrainer,
    )

    def config(name):
        return _config_dict(
            dataset, tmp_path / name, num_iterations=4, val_interval=1000,
            half_downsample_factor_interval=2, log_metrics_interval=1,
            log_image_interval=0,
            rasterisation_config={"tile_size": 32, "key_cap": 4096,
                                  "interpret": True},
            adaptive_controller_config={"num_iterations_warm_up": 100})

    texts = {}
    for name, make in (
            ("jax", lambda: JaxTrainer(jax_from_dict(config("jax")))),
            ("torch", lambda: GaussianPointCloudTrainer(
                from_dict(config("torch")), device="cpu"))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            make().train()
        texts[name] = out.getvalue()
    for key in ("train_loss", "train_l1_loss", "train_ssim_loss",
                "train_psnr"):
        got, want = _console(texts["torch"], key), _console(texts["jax"], key)
        assert len(got) == len(want) == 4, key
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)


def test_cli_template_and_train(dataset, tmp_path):
    import yaml

    template = tmp_path / "template.yaml"
    train_app.main(["--train_config", str(template), "--gen_template_only"])
    assert load_config(str(template)) == TrainConfig()

    cfg = _config_dict(dataset, tmp_path / "logs", num_iterations=3,
                       val_interval=2, enable_jax_profiler=True,
                       jax_profiler_start_iteration=0,
                       jax_profiler_num_iterations=1)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        train_app.main(["--train_config", str(path), "--device", "cpu"])
    for name in ("scene_2.parquet", "best_scene.parquet", "checkpoint_latest",
                 "torch_trace.json"):
        assert os.path.exists(tmp_path / "logs" / name), name
