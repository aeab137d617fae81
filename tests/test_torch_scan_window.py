"""Windows of train steps on the CPU: ``make_train_step(scan_steps=k)``
against the JAX single step called k times (which the JAX package's own
test holds equal to its ``lax.scan`` window; that scan is not run here in
interpret mode), against the port's own single steps bit for bit (with a
pose-refining window whose first index is -1), the trainer's window
scheduler against the JAX trainer's, and a short loop with
``steps_per_dispatch: 4`` against the same loop with 1.

Gates: the JAX comparisons are test_torch_train_step's (loss, l1, ssim,
psnr at rtol 1e-4; parameters within 2 lr a step, 1e-6 at the median).
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (  # noqa: E402
    RasterizerConfig as JRasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    TrainConfig as JTrainConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (  # noqa: E402
    RasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint as ck  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (  # noqa: E402
    TrainConfig,
    from_dict,
)
from tests.test_torch_key_cap import _gt, _states  # noqa: E402
from tests.test_torch_train_loop import _config_dict, _console  # noqa: E402
from tests.test_torch_train_loop import dataset  # noqa: E402,F401
from tests.test_torch_train_step import METRICS, _close_params  # noqa: E402
from tests.torch_port_scenes import Q_ID, make_K  # noqa: E402

K = 3


def _views(k=K):
    """k views: uint8 targets and identity rotations with seeded shifts."""
    rng = np.random.default_rng(4)
    images = np.stack([_gt()] + [
        (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        for _ in range(k - 1)])
    qs = np.tile(np.asarray(Q_ID, np.float32), (k, 1))
    ts = rng.normal(0.0, 0.02, (k, 3)).astype(np.float32)
    Ks = np.tile(make_K(), (k, 1, 1))
    return images, qs, ts, Ks


def _singles(step, state, views, idxs=None):
    rows = []
    aux = None
    for i in range(K):
        extra = () if idxs is None else (idxs[i],)
        state, m, aux = step(state, *(torch.from_numpy(v[i]) for v in views),
                             3, *extra)
        rows.append(m)
    return state, rows, aux


def test_window_matches_jax_single_steps():
    jstep, js, config, ts = _states(4096)
    views = _views()
    jrows = []
    for i in range(K):
        js, jm, _ = jstep(js, *(jnp.asarray(v[i]) for v in views),
                          jnp.asarray(3, jnp.int32))
        jrows.append(jm)
    snap = {"features": np.asarray(js.scene.features),
            "xyz": np.asarray(js.scene.xyz)}
    window = ttr.make_train_step(config, 64, 64, scan_steps=K, device="cpu",
                                 key_cap=4096)
    ts, stacked, aux = window(ts, *map(torch.from_numpy, views), 3)
    for k in METRICS:
        assert stacked[k].shape == (K,)
        np.testing.assert_allclose(stacked[k].numpy(),
                                   [float(m[k]) for m in jrows], rtol=1e-4)
    assert stacked["num_keys"].tolist() == [int(m["num_keys"])
                                            for m in jrows]
    assert int(ts.feat_opt.count) == int(ts.pos_opt.count) == K
    _close_params(ts, snap, K)
    assert set(aux) >= {"pred", "stats", "grad_features", "grad_xyz"}


def test_window_equals_its_single_steps_bit_for_bit():
    """The window's k capped steps against k exact single steps from the
    same state: the same state, metrics and last aux, bit for bit; the
    input state is left as it was."""
    _, _, config, ts = _states(4096)
    before = [t.clone() for t in ck.state_leaves(ts)]
    views = _views()
    single = ttr.make_train_step(config, 64, 64, device="cpu")
    s1, rows, a1 = _singles(single, ts, views)
    window = ttr.make_train_step(config, 64, 64, scan_steps=K, device="cpu")
    s2, stacked, a2 = window(ts, *map(torch.from_numpy, views), 3)
    for k in METRICS:
        assert torch.equal(stacked[k], torch.stack([m[k] for m in rows])), k
    assert stacked["num_keys"].tolist() == [m["num_keys"] for m in rows]
    for a, b in zip(ck.state_leaves(s1), ck.state_leaves(s2)):
        assert torch.equal(a, b)
    for k in ("pred", "grad_features", "grad_xyz", "point_depth"):
        assert torch.equal(a1[k], a2[k]), k
    for a, b in zip(before, ck.state_leaves(ts)):
        assert torch.equal(a, b)


def test_pose_refining_window_with_a_warm_up_index():
    """Pose refinement through a window whose first step holds the pose
    (index -1, as in the warm-up): the window's device indices give the
    single steps' state (host indices), bit for bit."""
    _, _, config, _ = _states(4096)
    config = dataclasses.replace(config, pose_refinement=True)
    _, _, _, ts = _states(4096)
    ts = ttr.init_train_state(ts.scene, config, num_train_images=2)
    views = _views()
    idxs = [-1, 1, 0]
    single = ttr.make_train_step(config, 64, 64, device="cpu")
    s1, rows, _ = _singles(single, ts, views, idxs)
    window = ttr.make_train_step(config, 64, 64, scan_steps=K, device="cpu")
    s2, stacked, aux = window(ts, *map(torch.from_numpy, views), 3, idxs)
    for k in METRICS:
        assert torch.equal(stacked[k], torch.stack([m[k] for m in rows])), k
    for a, b in zip(ck.state_leaves(s1), ck.state_leaves(s2)):
        assert torch.equal(a, b)
    assert s2.pose_opt["count"].tolist() == [1.0, 1.0]
    assert bool((s2.pose_deltas != 0).all())
    assert "grad_pose" in aux


def test_window_schedule_matches_jax():
    """The window scheduler on the config of the JAX package's scheduler
    test (steps_per_dispatch 8, 1300 iterations, validation every 400, SH
    bands every 300, downsample halvings every 250): the same window at
    every iteration, and every host cadence on a window boundary."""
    over = dict(steps_per_dispatch=8, num_iterations=1300, val_interval=400,
                increase_color_max_sh_band_interval=300,
                half_downsample_factor_interval=250)
    jt = jtr.GaussianPointCloudTrainer.__new__(jtr.GaussianPointCloudTrainer)
    jt.config = JTrainConfig(
        rasterisation_config=JRasterizerConfig(tile_size=32), **over)
    jt.mesh = None
    tt = ttr.GaussianPointCloudTrainer.__new__(ttr.GaussianPointCloudTrainer)
    tt.config = TrainConfig(**over)
    sizes = [tt._window_size(i) for i in range(over["num_iterations"])]
    assert sizes == [jt._window_size(i) for i in range(over["num_iterations"])]
    assert 8 in sizes and 1 in sizes
    it, starts, ends = -1, set(), set()
    while it + 1 < over["num_iterations"]:
        it += 1
        starts.add(it)
        it += sizes[it] - 1
        ends.add(it)
    assert all(k in ends for k in range(0, 1300, 100))
    assert all(k in starts for k in range(300, 1300, 300))
    assert all(k in starts for k in range(250, 1300, 250))


def _loop(dataset, log_dir, **over):
    trainer = ttr.GaussianPointCloudTrainer(
        from_dict(_config_dict(dataset, log_dir, **over)), device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = trainer.train()
    return trainer, state, out.getvalue()


def test_rebucket_matches_jax():
    """The key-capacity refit on a run of live key totals: the same grows
    (at once, to ``fit_key_cap``), the same 4x-hysteresis halvings and the
    same printed lines as the JAX trainer's."""
    caps = {}
    for name, mod, cfg in (
            ("jax", jtr, JTrainConfig(rasterisation_config=JRasterizerConfig(
                tile_size=32, key_cap=2 ** 17))),
            ("port", ttr, TrainConfig(rasterisation_config=RasterizerConfig(
                tile_size=32, key_cap=2 ** 17)))):
        t = mod.GaussianPointCloudTrainer.__new__(
            mod.GaussianPointCloudTrainer)
        t.config, t._key_cap, t._step_cache = cfg, 2 ** 17, {}
        out = io.StringIO()
        seen = []
        with contextlib.redirect_stdout(out):
            for n in (0, 90_000, 120_000, 130_000, 20_000, 9_000, 3_000, 100,
                      471_633, 471_633, 100_000):
                seen.append((t._maybe_rebucket_key_cap(n), t._key_cap))
        caps[name] = (seen, out.getvalue())
    assert caps["port"] == caps["jax"]
    assert "key_cap -> 655360 (live keys 471633)" in caps["port"][1]


def test_loop_with_windows_ends_where_the_loop_of_single_steps_ends(
        dataset, tmp_path):
    """12 iterations at factor 1 with a validation at 11 (no densify: its
    under-reconstructed move scales gradient noise by 100): with
    steps_per_dispatch 4 the loop runs the windows 1-4 and 5-8 and single
    steps elsewhere, and must end where the loop with 1 ends. A window
    stages its targets as uint8 and widens them by x 1/255 where the
    single step reads the dataset's u8 / 255 (one ulp apart on half the
    values), so the two agree at the gates of test_torch_train_step, not
    bit for bit. The console keeps every log point of the loop with 1, and
    its losses at rtol 1e-4."""
    base = _config_dict(dataset, tmp_path)
    over = dict(
        num_iterations=12, val_interval=11, initial_downsample_factor=1,
        half_downsample_factor_interval=100,
        increase_color_max_sh_band_interval=100, log_image_interval=100,
        rasterisation_config={"tile_size": 32, "key_cap": 4096},
        adaptive_controller_config=dict(
            base["adaptive_controller_config"], num_iterations_warm_up=100))
    t1, s1, out1 = _loop(dataset, tmp_path / "one", **over)
    t4, s4, out4 = _loop(dataset, tmp_path / "four", steps_per_dispatch=4,
                         **over)
    it, windows = 0, []
    while it < 12:  # the schedule as train() walks it
        windows.append((it, t4._window_size(it)))
        it += windows[-1][1]
    assert windows == [(0, 1), (1, 4), (5, 4), (9, 1), (10, 1), (11, 1)]
    assert {k[3] for k in t4._step_cache} == {0, 4}
    assert sorted(t1._step_cache) == [(64, 64)]  # exact keys
    # the parameters at the train-step gates (Adam turns a noise-level
    # gradient's sign into +-lr a step)
    _close_params(s4, {"features": s1.scene.features.numpy(),
                       "xyz": s1.scene.xyz.numpy()}, 12)
    assert int(s4.feat_opt.count) == int(s1.feat_opt.count) == 12
    for key in ("train_iteration", "train_loss", "train_psnr", "val_psnr"):
        got = _console(out4, key)
        want = _console(out1, key)
        assert len(got) == len(want) > 0, key
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=key)
    assert t4._key_cap == 4096  # the refit at 0 kept the config's capacity
