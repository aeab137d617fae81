"""Rules of the port that no parity test covers: it never imports JAX or
the JAX package, it imports without CUDA (and without PyYAML, PIL, pandas
or tensorboardX), gradients
flow through its rasterizer, the options it does not port and the
combinations the JAX trainer refuses raise, and its
kernel wrappers reject malformed tensors and never launch on the CPU."""
import ast
import dataclasses
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as attrs
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, expand, histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr
from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "taichi_3d_gaussian_splatting_tpu_torch"
BANNED = re.compile(r"^(jax|jaxlib|optax|taichi_3d_gaussian_splatting_tpu(?!_torch))(\.|$)")


def _port_files():
    """The port, and the card tests with what they import of tests/ (the
    card runs them with ``--noconftest``, on a machine without JAX)."""
    tests = ROOT / "tests"
    return sorted(PORT.rglob("*.py")) + [
        tests / f"{name}.py" for name in (
            "test_torch_kernels_cuda", "test_torch_stages",
            "test_torch_card_paths", "torch_port_scenes")]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f) if BANNED.match(m)]
    assert bad == []


def test_banned_pattern_tells_the_packages_apart():
    assert BANNED.match("taichi_3d_gaussian_splatting_tpu.ops.tiling")
    assert BANNED.match("jax.numpy") and BANNED.match("optax")
    assert not BANNED.match("taichi_3d_gaussian_splatting_tpu_torch.ops")
    assert not BANNED.match("jaxtyping")


def test_package_imports_without_cuda_or_jax():
    """Every module imports in a fresh interpreter with CUDA hidden, and
    neither JAX nor triton gets loaded and no kernel gets built."""
    mods = sorted(
        "taichi_3d_gaussian_splatting_tpu_torch."
        + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build\n"
        "assert not cuda_build._loaded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'taichi_3d_gaussian_splatting_tpu')]\n"
        "assert not bad, bad\n"
        "import torch; assert not torch.cuda.is_available()\n")
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(mods) >= 18


def test_config_imports_without_yaml():
    """The card's machine has no PyYAML: nothing on the train step may
    need it. Only load_config imports it."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None  # an import of yaml now fails\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.training import "
        "config, trainer\n"
        "config.from_dict({'feature_learning_rate': '1e-4'})\n"
        "try:\n"
        "    config.load_config('missing.yaml')\n"
        "except ImportError:\n"
        "    print('load_config needs yaml')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "load_config needs yaml"


def test_loop_imports_without_optional_packages():
    """The card's machine may lack PIL, pandas, PyYAML, tensorboardX and
    scipy: the dataset, the trainer, the train CLI and the quality gate
    import without them (each is imported where it is used), and the
    trainer then has no writer."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'pandas', 'yaml', 'tensorboardX', 'scipy'):\n"
        "    sys.modules[m] = None  # an import of it now fails\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.data import dataset\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.training import "
        "trainer\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.apps import train\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.tools import "
        "quality_run\n"
        "from taichi_3d_gaussian_splatting_tpu_torch.training.config import "
        "TrainConfig\n"
        "class T(trainer.GaussianPointCloudTrainer):\n"
        "    def _load_datasets(self):\n"
        "        return [], []\n"
        "    def _load_scene(self):\n"
        "        return None\n"
        "t = T(TrainConfig(summary_writer_log_dir=sys.argv[1]), 'cpu')\n"
        "assert t.writer is None\n"
        "print('imported')\n")
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, "-c", code, tmp], cwd=ROOT,
                           env={"PATH": "/usr/bin:/bin",
                                "PYTHONPATH": str(ROOT)},
                           capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "imported"


TP_REFUSAL = ("tile_parallel_devices composes with neither "
              "data_parallel/multihost")


@pytest.mark.parametrize("over, error, match", [
    # the combinations the JAX trainer refuses, with its message
    ({"tile_parallel_devices": 2, "data_parallel_devices": 2}, ValueError,
     TP_REFUSAL),
    ({"tile_parallel_devices": 2, "multihost": True}, ValueError,
     TP_REFUSAL),
    ({"tile_parallel_devices": 2, "pose_refinement": True}, ValueError,
     TP_REFUSAL),
    ({"tile_parallel_devices": 2, "steps_per_dispatch": 4}, ValueError,
     "tile_parallel training runs one dispatch per step"),
    # a multi-device config outside a process group of its size
    ({"data_parallel_devices": 2}, RuntimeError, "spawns the ranks"),
])
def test_trainer_refuses_unported_options(over, error, match, tmp_path):
    config = dataclasses.replace(
        TrainConfig(summary_writer_log_dir=str(tmp_path)), **over)
    with pytest.raises(error, match=match):
        trainer.GaussianPointCloudTrainer(config, device="cpu")
    assert list(tmp_path.iterdir()) == []  # refused before anything ran


def _scene_tensors():
    xyz, feats, invalid = make_scene(50, seed=2)
    return [torch.from_numpy(a) for a in (xyz, feats, invalid, Q_ID, T_ID)]


@pytest.mark.parametrize("which", ["xyz", "features"])
def test_rasterize_gradients_flow(which):
    xyz, feats, invalid, q, t = _scene_tensors()
    leaf = (xyz if which == "xyz" else feats).requires_grad_(True)
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    out = tr.rasterize(xyz, feats, invalid, q, t, cam, tr.RasterizerConfig())
    (grad,) = torch.autograd.grad(out.rgb.sum(), leaf)
    assert grad.shape == leaf.shape
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0


def test_rasterizer_config_refuses_deferred_options():
    with pytest.raises(ValueError):
        tr.RasterizerConfig(slim=True, rgb_only=True)


def test_band_step_refuses_windows():
    with pytest.raises(ValueError, match="one dispatch per step"):
        trainer.make_train_step(TrainConfig(), 64, 64, scan_steps=2,
                                device="cpu", split_bands=True)


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _call_histogram(ids):
    return histogram.bucket_histogram(ids, 4)


def _call_tile_ranges(fused):
    return histogram.tile_ranges(fused, 20, 4)


def _call_expand(offsets):
    z = _i32(3)
    return expand.expand_keys(offsets, z, z, z, z, torch.zeros(10, 3),
                              total=0, tiles_u=2, tile_w=32, tile_h=32,
                              dbits=20, sentinel=(5 << 20) - 1,
                              exact_cull=True)


def _call_blend(table):
    return blend.blend_forward(table, _i32(4), _i32(4), tile=32, tiles_x=2,
                               tiles_y=2)


def _call_blend_backward(d_rgb):
    return blend.blend_backward(torch.zeros(16, 8), _i32(4), _i32(4), d_rgb,
                                torch.zeros(4, 1024, 3), tile=32, tiles_x=2,
                                tiles_y=2)


def _call_segment_reduce(rows):
    return sr.segment_reduce(rows, _i32(3), _i32(3))


@pytest.mark.parametrize("call, good", [
    (_call_histogram, _i32(8)),
    (_call_tile_ranges, _i32(8)),
    (_call_expand, _i32(3)),
    (_call_blend, torch.zeros(16, 8)),
    (_call_blend_backward, torch.zeros(4, 1024, 3)),
    (_call_segment_reduce, torch.zeros(12, 8)),
])
def test_wrappers_check_their_inputs(call, good):
    call(good)  # the plain version runs for a CPU tensor
    wrong_dtype = good.to(torch.float64 if good.is_floating_point()
                          else torch.int64)
    with pytest.raises(TypeError):
        call(wrong_dtype)
    with pytest.raises(ValueError):
        call(good[None])  # wrong rank
    if good.dim() == 2:
        with pytest.raises(ValueError):
            call(good.t().contiguous().t())  # not contiguous
    with pytest.raises(ValueError):
        call(good.to("meta"))  # neither CPU nor CUDA


def test_wrappers_check_shapes():
    with pytest.raises(ValueError, match="d_rgb_tiles"):
        _call_blend_backward(torch.zeros(4, 512, 3))
    with pytest.raises(ValueError, match="counts"):
        sr.segment_reduce(torch.zeros(12, 8), _i32(3), _i32(4))


COUNTERS = (histogram.tile_ranges, expand.slot_keys, expand.sorted_table, blend.blend_forward,
            blend.blend_backward, sr.segment_reduce, sr.segment_reduce_sorted,
            attrs.point_attributes, attrs.point_attributes_vjp,
            histogram.tile_counts)


def test_point_attributes_refuses_a_gradient():
    """The attribute kernel's wrapper takes no gradient: a caller that
    wants one must take the plain version (compute_raw_attrs does)."""
    xyz, feats, _, q, t = _scene_tensors()
    K = torch.from_numpy(make_K())
    with pytest.raises(ValueError, match="no gradient"):
        attrs.point_attributes(xyz.clone().requires_grad_(True), feats, q, t,
                               K)
    with torch.no_grad():
        got = attrs.point_attributes(xyz.clone().requires_grad_(True), feats,
                                     q, t, K)
    for g, w in zip(got, attrs.point_attributes_plain(xyz, feats, q, t, K)):
        assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))


def test_wrappers_on_cpu_never_launch():
    before = [f.launches for f in COUNTERS]
    xyz, feats, invalid, q, t = _scene_tensors()
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    out = tr.rasterize(xyz, feats, invalid, q, t, cam, tr.RasterizerConfig())
    assert np.isfinite(out.rgb.numpy()).all()
    config = TrainConfig()
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device="cpu"), config)
    step = trainer.make_train_step(config, 64, 64, device="cpu")
    gt = torch.zeros((64, 64, 3), dtype=torch.uint8)
    _, metrics, aux = step(state, gt, q, t, cam.K, 3)
    assert np.isfinite(float(metrics["loss"]))
    assert bool(torch.isfinite(aux["grad_features"]).all())
    assert before == [f.launches for f in COUNTERS]
