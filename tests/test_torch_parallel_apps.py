"""The port's multi-device entry points on the CPU, over gloo:

- ``apps.train`` with ``data_parallel_devices: 2`` spawns two ranks; the
  main rank writes the scenes, checkpoint and console metrics, and the
  losses equal (rtol 1e-5: other thread counts add in other orders) those
  of the same job run as two ``multihost`` processes, where the non-main
  process writes and prints nothing (tests/test_multihost.py:75);
- ``apps.render --data_parallel`` as two ranks of a torchrun-style
  environment writes the plain loop's frames byte for byte
  (tests/test_parallel.py:497); ``--tile_parallel`` renders a 96-row
  frame as 128 rows in two bands, crops it back, and writes the plain
  loop's frames byte for byte too (visibility is decided on the 96
  rows);
- ``parallel.mh_smoke`` as two processes equals ``single_process_reference``
  (the JAX harness's gates: losses rtol 1e-6, features atol 2e-3, xyz
  1e-5, visibility counts exact).

Every process has a timeout: a hang fails the test.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.apps import render as trender
from taichi_3d_gaussian_splatting_tpu_torch.models import scene as tscene
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh
from tests.test_torch_train_loop import _config_dict, write_dataset
from tests.torch_port_scenes import make_K, make_scene

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _env():
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return env


def _train_cmd(cfg_path):
    return [sys.executable, "-m",
            "taichi_3d_gaussian_splatting_tpu_torch.apps.train",
            "--train_config", str(cfg_path), "--device", "cpu"]


def _losses(stdout):
    return [float(line.split("=")[1].rstrip(";"))
            for line in stdout.splitlines() if line.startswith("train_loss=")]


def _write_cfg(path, cfg):
    import yaml

    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(tmp_path_factory.mktemp("dp_data"))


@pytest.fixture(scope="module")
def spawned_run(dataset, tmp_path_factory):
    logs = tmp_path_factory.mktemp("dp_logs")
    cfg = _write_cfg(logs / "cfg.yaml", _config_dict(
        dataset, logs, data_parallel_devices=2))
    r = subprocess.run(_train_cmd(cfg), cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT)
    return logs, r


def test_train_cli_spawns_two_ranks(spawned_run):
    logs, r = spawned_run
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("backend gloo") == 2
    assert (logs / "scene_7.parquet").exists()
    assert (logs / "checkpoint_latest").is_dir()
    losses = _losses(r.stdout)
    # console metrics once (the main rank), every iteration
    assert len(losses) == 8 and np.isfinite(losses).all()


def test_train_cli_multihost_processes_agree(spawned_run, dataset,
                                             tmp_path):
    _, spawned = spawned_run
    port = mh.free_port()
    procs = []
    for pid in (0, 1):
        logs = tmp_path / f"logs_{pid}"
        cfg = _write_cfg(tmp_path / f"cfg_{pid}.yaml", _config_dict(
            dataset, logs, multihost=True,
            coordinator_address=f"127.0.0.1:{port}", num_processes=2,
            process_id=pid))
        procs.append(subprocess.Popen(
            _train_cmd(cfg), cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs_out = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            logs_out.append(out)
            assert p.returncode == 0, out[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # the main process wrote; the other did not, and printed no metrics
    assert (tmp_path / "logs_0" / "scene_7.parquet").exists()
    assert not (tmp_path / "logs_1" / "scene_7.parquet").exists()
    assert "train_loss=" not in logs_out[1]
    np.testing.assert_allclose(_losses(logs_out[0]), _losses(spawned.stdout),
                               rtol=1e-5)


@pytest.fixture(scope="module")
def render_inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("render")
    xyz, feats, _ = make_scene(120, seed=17)
    tscene.to_ply(tscene.create_scene(xyz, tscene.SceneConfig(),
                                      features=feats, device="cpu"),
                  str(tmp / "scene.ply"))
    rng = np.random.default_rng(3)
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, :3, 3] = rng.normal(0, 0.05, (5, 3))
    torch.save(torch.from_numpy(poses), tmp / "poses.pt")
    # a dataset .json of 96x64 views: 3 tile rows, padded to 4 for 2 bands
    from PIL import Image

    records = []
    for i in range(3):
        path = tmp / f"view{i}.png"
        Image.fromarray(rng.integers(0, 255, (96, 64, 3), dtype=np.uint8)
                        ).save(path)
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": poses[i].tolist(),
                        "camera_intrinsics": make_K(64, 96).tolist(),
                        "camera_height": 96, "camera_width": 64,
                        "camera_id": 0})
    (tmp / "views.json").write_text(json.dumps(records))
    return tmp


def _render_cmd(inputs, out, poses, *extra):
    return [sys.executable, "-m",
            "taichi_3d_gaussian_splatting_tpu_torch.apps.render",
            "--parquet_path", str(inputs / "scene.ply"), "--poses",
            str(inputs / poses), "--output_prefix", str(out), "--device",
            "cpu", *extra]


def _frames(out):
    from PIL import Image

    return {p.name: np.asarray(Image.open(p)) for p in sorted(out.iterdir())}


def _render(inputs, out, poses, *extra):
    """The render CLI: in this process, or with ``extra`` flags as two
    ranks of the group a torchrun-style environment describes."""
    if not extra:
        trender.main(_render_cmd(inputs, out, poses)[3:])
        return _frames(out)
    port = mh.free_port()
    procs = []
    for rank in (0, 1):
        env = dict(_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            _render_cmd(inputs, out, poses, *extra), cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, log[-4000:]
            assert "backend gloo" in log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return _frames(out)


def test_render_cli_data_parallel_matches_plain_loop(render_inputs,
                                                     tmp_path):
    plain = _render(render_inputs, tmp_path / "plain", "views.json")
    dp = _render(render_inputs, tmp_path / "dp", "views.json",
                 "--data_parallel")
    assert sorted(dp) == sorted(plain) == [f"frame_{i:03}.png"
                                           for i in range(3)]
    for name in plain:
        np.testing.assert_array_equal(dp[name], plain[name])


def test_render_cli_tile_parallel_matches_plain_loop(render_inputs,
                                                     tmp_path):
    plain = _render(render_inputs, tmp_path / "plain", "views.json")
    tp = _render(render_inputs, tmp_path / "tp", "views.json",
                 "--tile_parallel")
    assert sorted(tp) == sorted(plain)
    for name in plain:
        assert tp[name].shape == plain[name].shape == (96, 64, 3)
        assert plain[name].max() > 0
        np.testing.assert_array_equal(tp[name], plain[name])


def test_mh_smoke_two_processes_match_single_process(tmp_path):
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.mh_smoke import (
        single_process_reference,
    )

    port = mh.free_port()
    out = tmp_path / "mh0.npz"
    procs = []
    for pid in (0, 1):
        cmd = [sys.executable, "-m",
               "taichi_3d_gaussian_splatting_tpu_torch.parallel.mh_smoke",
               "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
               "--process_id", str(pid), "--steps", "2", "--device", "cpu"]
        if pid == 0:
            cmd += ["--out", str(out)]
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=_env(),
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, log[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ref = single_process_reference(2, device="cpu")
    finally:
        torch.set_num_threads(threads)
    got = dict(np.load(out))
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)
    np.testing.assert_allclose(got["features"], ref["features"], atol=2e-3)
    np.testing.assert_allclose(got["xyz"], ref["xyz"], atol=1e-5)
    np.testing.assert_array_equal(got["num_in_camera"], ref["num_in_camera"])
