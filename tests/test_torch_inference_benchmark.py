"""The render path at a static key capacity, and the two measurement
tools, against the JAX package on the CPU (the JAX side in interpret
mode, the port through its plain versions):

- the capped ``rasterize(rgb_only)`` against JAX's ``rasterize`` at the
  same ``key_cap``, below the key total (keys dropped) and above it: rgb
  within 1e-4 (the image gate); above the total it is the port's exact
  frame bit for bit;
- the renderer's fitted capacity and the key totals it probed equal the
  JAX renderer's ``_fit_cap``'s on the same scene and poses;
- ``tools/inference_benchmark.py`` and ``benchmark/inference_benchmark.py``
  on the same tiny dataset: the same key_cap, PNGs within one 8-bit level;
- the tools' ``cuda`` default fails without a card;
- ``tools/profile_attribution.analyze`` on a synthetic chrome trace, and a
  CPU trace carrying the ``gs.*`` stage ranges;
- a frame past the capacity counts 1.
"""
import gzip
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.apps import render as jrender  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.models import scene as jscene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.apps import render as trender  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.models import scene as tscene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.tools import (  # noqa: E402
    inference_benchmark as tib,
)
from taichi_3d_gaussian_splatting_tpu_torch.tools import (  # noqa: E402
    profile_attribution as tpa,
)
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the seeded 200-point frame has 283 keys: 128 drops keys (the JAX blend
# needs a multiple of 128), 512 holds them all
CAP_BELOW, CAP_ABOVE = 128, 512


def _frame_inputs():
    xyz, feats, invalid = make_scene(200, seed=7)
    return xyz, feats, invalid, Q_ID, T_ID


def _port_frame(cfg, key_cap=None, num_keys=False):
    t = [torch.from_numpy(a) for a in _frame_inputs()]
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    return tr.rasterize(*t, cam, cfg, return_num_keys=num_keys,
                        key_cap=key_cap)


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("cap", [CAP_BELOW, CAP_ABOVE])
def test_capped_frame_matches_jax(cap, pack):
    jcfg = jr.RasterizerConfig(tile_size=32, key_cap=cap, rgb_only=True,
                               pack_sort_colors=pack, interpret=True)
    jcam = jr.Camera(jnp.asarray(make_K()), 64, 64)
    want, jtotal = jr.rasterize(*map(jnp.asarray, _frame_inputs()), jcam,
                                jcfg, return_num_keys=True)
    tcfg = tr.RasterizerConfig(tile_size=32, rgb_only=True,
                               pack_sort_colors=pack)
    got, total = _port_frame(tcfg, key_cap=cap, num_keys=True)
    assert isinstance(total, torch.Tensor) and total.dim() == 0
    assert int(total) == int(jtotal) == 283
    assert (int(total) > cap) == (cap == CAP_BELOW)
    rgb = got.rgb.numpy()
    assert rgb.shape == (64, 64, 3) and rgb.max() > 0
    np.testing.assert_allclose(rgb, np.asarray(want.rgb), rtol=0, atol=1e-4)
    if cap == CAP_BELOW:  # the dropped keys show in the frame
        exact = _port_frame(tcfg)
        assert np.abs(rgb - exact.rgb.numpy()).max() > 1e-3


@pytest.mark.parametrize("cfg", [
    dict(rgb_only=True), dict(rgb_only=True, pack_sort_colors=True), {}])
def test_capped_frame_above_total_is_the_exact_frame(cfg):
    tcfg = tr.RasterizerConfig(tile_size=32, **cfg)
    exact, total = _port_frame(tcfg, num_keys=True)
    assert total == 283
    for cap in (CAP_ABOVE, 283):
        got = _port_frame(tcfg, key_cap=cap)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(exact, f)), (cap, f)


def _orbit(n):
    """n camera->world poses turning about the vertical axis and backing
    off, so that the key totals differ from pose to pose."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        a = 0.05 * (i - n // 2)
        out[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                          [-np.sin(a), 0, np.cos(a)]]
        out[i, :3, 3] = [0.05 * i, 0.0, -0.1 * (i % 5)]
        out[i, 3, 3] = 1.0
    return out


@pytest.fixture(scope="module")
def scene_ply(tmp_path_factory):
    d = tmp_path_factory.mktemp("bench_scene")
    xyz, feats, invalid = make_scene(150, seed=3)
    s = tscene.create_scene(xyz[~invalid], tscene.SceneConfig(),
                            features=feats[~invalid], device="cpu")
    path = d / "scene.ply"
    tscene.to_ply(s, str(path))
    return path


def test_fitted_cap_matches_jax(scene_ply, monkeypatch):
    """17 poses (every 2nd probed): the same probed totals, the same
    worst, the same capacity as JAX ``GaussianPointRenderer._fit_cap``."""
    poses = _orbit(17)
    seen = {"jax": [], "port": []}

    def recorder(key, fit):
        def fit_and_record(total, **kw):
            seen[key].append((int(total), kw))
            return fit(total, **kw)
        return fit_and_record

    monkeypatch.setattr(jtr, "fit_key_cap", recorder("jax", jtr.fit_key_cap))
    monkeypatch.setattr(trender, "fit_key_cap",
                        recorder("port", trender.fit_key_cap))
    probed = []
    key_total = tr.key_total

    def probe(*a, **kw):
        probed.append(key_total(*a, **kw))
        return probed[-1]

    monkeypatch.setattr(trender, "key_total", probe)
    kw = dict(parquet_paths=[str(scene_ply)], image_height=64,
              image_width=64, camera_intrinsics=make_K())
    port = trender.GaussianPointRenderer(trender.RendererConfig(**kw), poses,
                                         device="cpu")
    # the JAX renderer's state, as its __init__ sets it before _fit_cap
    # (its probe capacity cut to 4096: the probed total is the true one)
    jrd = jrender.GaussianPointRenderer.__new__(jrender.GaussianPointRenderer)
    jrd.scene = jscene.from_ply(str(scene_ply), jscene.SceneConfig(
        max_num_points_ratio=None))
    jrd.poses = poses
    jrd.rcfg = jr.RasterizerConfig(
        near_plane=0.8, far_plane=1000.0, depth_to_sort_key_scale=100.0,
        tile_size=32, rgb_only=True, key_cap=4096, interpret=True)
    jcap, _ = jrd._fit_cap(jr.Camera(K=jnp.asarray(make_K()), width=64,
                                     height=64))
    assert len(probed) == 9 and len(set(probed)) > 1
    assert seen["port"] == seen["jax"] == [(max(probed), {"headroom": 1.15})]
    assert port.key_cap == jcap == jtr.fit_key_cap(max(probed),
                                                    headroom=1.15)


def test_frame_past_the_capacity_counts_one(scene_ply, capsys):
    kw = dict(parquet_paths=[str(scene_ply)], image_height=64,
              image_width=64, camera_intrinsics=make_K())
    r = trender.GaussianPointRenderer(trender.RendererConfig(**kw),
                                      _orbit(2), device="cpu")
    q, t = trender.se3_to_qt(r.poses)
    fitted = r.render(q[0], t[0])
    assert int(r.over_cap) == 0
    total = tr.key_total(r.scene.xyz, r.scene.features, r.scene.invalid,
                         q[0], t[0], r.camera, r.rcfg)
    r.key_cap = total - 1
    dropped = r.render(q[0], t[0])
    assert int(r.over_cap) == 1
    assert not torch.equal(fitted, dropped)
    r.key_cap = total  # at the total nothing drops
    assert torch.equal(r.render(q[0], t[0]), fitted)
    assert int(r.over_cap) == 1
    capsys.readouterr()
    r.key_cap = 16
    frames = dict(r.frames())  # both poses past the capacity
    assert sorted(frames) == [0, 1]
    err = capsys.readouterr().err
    assert int(r.over_cap) == 3 and err.count("passed the key capacity") == 1
    assert "3 frame(s)" in err


def _write_dataset(d: Path) -> Path:
    """Four PNG views: three of 64x64, one of 96x64 (two buckets)."""
    rng = np.random.default_rng(5)
    records = []
    for i, (pose, w) in enumerate(zip(_orbit(4), (64, 64, 96, 64))):
        path = d / f"view_{i}.png"
        Image.fromarray(rng.integers(0, 255, (64, w, 3), dtype=np.uint8),
                        "RGB").save(path)
        K = make_K(w, 64)
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": pose.tolist(),
                        "camera_intrinsics": K.tolist(),
                        "camera_height": 64, "camera_width": w,
                        "camera_id": 0})
    path = d / "views.json"
    path.write_text(json.dumps(records))
    return path


def test_benchmark_scripts_agree(scene_ply, tmp_path, monkeypatch, capsys):
    ds = _write_dataset(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "jax_inference_benchmark", ROOT / "benchmark" / "inference_benchmark.py")
    jib = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jib)
    common = ["--scene", str(scene_ply), "--dataset", str(ds),
              "--warmup", "2", "--iters", "3"]
    monkeypatch.setattr(sys, "argv", ["inference_benchmark.py", *common,
                                      "--save_image",
                                      str(tmp_path / "jax.png")])
    jib.main()
    jout = capsys.readouterr().out
    rec = tib.main(common + ["--save_image", str(tmp_path / "port.png"),
                             "--device", "cpu"])
    out = capsys.readouterr().out
    cap = lambda s: int(re.search(r"key_cap (\d+)", s).group(1))  # noqa: E731
    assert cap(out) == cap(jout) == rec["key_cap"]
    assert rec["key_cap"] == jtr.fit_key_cap(rec["worst_key_total"],
                                             headroom=1.1)
    assert rec["frames_over_cap"] == 0 and rec["graphs"] == []
    for line in ("Inference time: ", "FPS: ", "Mpix/s: "):
        assert line in out and line in jout
    want = np.asarray(Image.open(tmp_path / "jax.png")).astype(np.int16)
    got = np.asarray(Image.open(tmp_path / "port.png")).astype(np.int16)
    assert got.shape == want.shape == (64, 64, 3) and got.max() > 0
    assert np.abs(got - want).max() <= 1


def test_cuda_default_fails_without_a_card(scene_ply, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    ds = _write_dataset(tmp_path)
    with pytest.raises(SystemExit) as e:
        tib.main(["--scene", str(scene_ply), "--dataset", str(ds)])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit) as e:
        tpa.main(["--points", "100", "--out", str(tmp_path / "trace")])
    assert e.value.code not in (0, None)


def _synthetic_trace():
    """Two runs' events on one host thread (tid 1) and one device stream:
    gs.tiling holds launches 1 and 2, gs.blend launch 3 (inside an outer
    gs.attributes range, which the innermost range wins), launch 4 lies
    outside every range; a CPU op and a range of another name count no
    device time."""
    ev = []

    def rng(name, ts, dur, tid=1, cat="user_annotation"):
        ev.append({"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
                   "ts": ts, "dur": dur})

    def launch(corr, ts, kernel, dur, cat="kernel"):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "pid": 1, "tid": 1, "ts": ts, "dur": 2,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": kernel, "pid": 0, "tid": 7,
                   "ts": ts + 50, "dur": dur, "args": {"correlation": corr}})

    for run in range(2):
        o = 1000 * run
        rng("gs.tiling", o + 0, 100)
        launch(10 * run + 1, o + 10, "slot_keys_kernel(int)", 30.0)
        launch(10 * run + 2, o + 20, "Memcpy DtoD", 4.0, cat="gpu_memcpy")
        rng("gs.attributes", o + 200, 300)
        rng("gs.blend", o + 250, 100)
        launch(10 * run + 3, o + 260, "blend_forward_kernel(float)", 100.0)
        launch(10 * run + 4, o + 600, "elementwise_kernel", 6.0)
        rng("ProfilerStep#1", o + 0, 900)
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                   "pid": 1, "tid": 1, "ts": o + 600, "dur": 9})
    return {"traceEvents": ev}


def test_analyze_sums_a_synthetic_trace(tmp_path):
    trace = _synthetic_trace()
    (tmp_path / "a.json").write_text(json.dumps(trace))
    gz = tmp_path / "gz"
    gz.mkdir()
    with gzip.open(gz / "b.trace.json.gz", "wt") as f:
        json.dump(trace, f)
    for path in (str(tmp_path / "a.json"), str(gz)):
        got = tpa.analyze(path, runs=2)
        assert got["device_ms_per_run"] == pytest.approx(0.140)
        assert got["by_stage"] == pytest.approx(
            {"gs.tiling": 0.034, "gs.blend": 0.100, tpa.UNMARKED: 0.006})
        assert got["by_kernel"] == pytest.approx(
            {"slot_keys_kernel(int)": 0.030, "Memcpy DtoD": 0.004,
             "blend_forward_kernel(float)": 0.100,
             "elementwise_kernel": 0.006})
    # --analyze-only reads a saved trace
    assert tpa.main(["--analyze-only", str(gz), "--runs", "2"])[
        "by_stage"] == got["by_stage"]


def test_profile_trace_on_the_cpu_marks_the_stages(tmp_path):
    got = tpa.main(["--points", "400", "--runs", "1", "--rgb-only",
                    "--fit-cap", "--device", "cpu", "--out", str(tmp_path)])
    assert got["key_cap"] == jtr.fit_key_cap(got["key_total"], headroom=1.1)
    assert got["device_ms_per_run"] == 0.0  # a CPU trace: no device time
    names = {e["name"] for e in json.loads(Path(got["trace"]).read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"gs.attributes", "gs.tiling", "gs.blend", "gs.assemble"} <= names
