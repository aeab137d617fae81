"""Windows of data-parallel steps on the CPU:
``make_dp_train_step(scan_steps=k)`` on two gloo ranks against the JAX
package's ``make_dp_train_step(scan_steps=2)`` on two devices of the CPU
mesh, in its cases tests/test_parallel.py:139 and :351 (the pose case with
a -1 row first, as in the warm-up), at a key capacity above and below the
views' key totals; against its own eager capped steps bit for bit; at
world 1 against the single-device window; and the trainer with
``data_parallel_devices: 2`` and ``steps_per_dispatch: 4`` against the
JAX trainer's draw and window schedule and against its own loop with
``steps_per_dispatch: 1``.

The cases render 32x8 tiles (a shape of tests/test_rasterizer.py:426)
rather than 32x32, so that the views' 165-177 keys lie above a capacity
of 128 (the JAX blend takes multiples of 128) and below 256.

Gates: losses at rtol 1e-4; Adam moments at the gradient gate, atol 5e-4,
rtol 1e-3 (the first moment over 1 - b1 as tests/test_torch_data_parallel
.py holds gradients); parameters within 2 lr a step of JAX's, 1e-6 at the
median; the controller's visibility counts and the last step's
``in_camera`` exact; pose rows within 2 lr a step, their counts exact.
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.data import dataset as jds  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (  # noqa: E402
    RasterizerConfig as JRasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu.parallel import data_parallel as jdp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.parallel import multihost as jmh  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    from_dict as jax_from_dict,
)
from taichi_3d_gaussian_splatting_tpu_torch.convert import (  # noqa: E402
    train_state_from_jax,
)
from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E402
    make_dp_train_step,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training.checkpoint import (  # noqa: E402
    state_leaves,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (  # noqa: E402
    from_dict,
)
from tests import torch_dist_workers as W  # noqa: E402
from tests.test_torch_data_parallel import (  # noqa: E402
    B1,
    GATE,
    _close_params,
    _jax_config,
    _jax_state,
)
from tests.test_torch_train_loop import _config_dict, write_dataset  # noqa: E402
from tests.torch_port_scenes import make_K  # noqa: E402

SPD = 4
LOOP = dict(
    num_iterations=12, val_interval=11, initial_downsample_factor=1,
    half_downsample_factor_interval=100,
    increase_color_max_sh_band_interval=100, log_image_interval=100,
    rasterisation_config={"tile_size": 32, "key_cap": 4096})


def _loop_dict(data, log_dir, **over):
    base = _config_dict(data, log_dir)
    d = _config_dict(data, log_dir, **dict(
        LOOP, adaptive_controller_config=dict(
            base["adaptive_controller_config"], num_iterations_warm_up=100)))
    d.update(over)
    return d


def write_mixed_dataset(tmp):
    """``write_dataset``'s views and two more at 32x64 (rows x columns):
    most dispatches of two ranks mix the sizes."""
    from PIL import Image

    write_dataset(tmp)
    records = json.loads((tmp / "train.json").read_text())
    rng = np.random.default_rng(1)
    for i in range(2):
        path = tmp / f"wide_{i}.png"
        Image.fromarray((rng.random((32, 64, 3)) * 255).astype(
            np.uint8)).save(path)
        records.append(dict(records[i], image_path=str(path),
                            camera_height=32, camera_width=64,
                            camera_intrinsics=make_K(64, 32).tolist()))
    (tmp / "train.json").write_text(json.dumps(records))
    return tmp


def _jax_window(name, cap, mesh):
    seed, imgs, ts, idx, pose = W.win_case(name)
    config = dataclasses.replace(_jax_config(pose), rasterisation_config=(
        JRasterizerConfig(key_cap=cap, interpret=True, **W.WIN_TILE)))
    xyz, feats = W.dp_scene(seed=seed)
    state = jdp.replicate(mesh, _jax_state(config, xyz, feats, pose))
    *views, idxs = W.win_inputs(name, [0, 1])
    arrays = tuple(jnp.asarray(v.numpy()) for v in views)
    if pose:
        arrays = arrays + (jnp.asarray(idxs, jnp.int32),)
    sharded = jdp.shard_batch(mesh, *arrays, batch_axis=1)
    window = jdp.make_dp_train_step(config, W.HW, W.HW, mesh,
                                    scan_steps=W.WIN_STEPS)[0]
    new, metrics, fs = window(state, *sharded[:4], jnp.asarray(3, jnp.int32),
                              *sharded[4:])
    out = {"features": new.scene.features, "xyz": new.scene.xyz,
           "feat_mu": new.feat_opt[0].mu, "pos_mu": new.pos_opt[0].mu,
           "ctrl_num_in_camera": new.ctrl.num_in_camera}
    if pose:
        out["pose_deltas"] = new.pose_deltas
        out.update({f"pose_{k}": v for k, v in new.pose_opt.items()})
    return {"state": {k: np.asarray(v) for k, v in out.items()},
            "metrics": {k: np.asarray(v) for k, v in metrics.items()},
            "in_camera": np.asarray(fs["in_camera"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    uniform = write_dataset(tmp_path_factory.mktemp("dp_window_data"))
    mixed = write_mixed_dataset(tmp_path_factory.mktemp("dp_window_mixed"))
    logs = tmp_path_factory.mktemp("dp_window_logs")
    loops = {
        "windows": _loop_dict(uniform, logs / "windows",
                              data_parallel_devices=2,
                              steps_per_dispatch=SPD),
        "singles": _loop_dict(uniform, logs / "singles",
                              data_parallel_devices=2),
        "mixed": _loop_dict(mixed, logs / "mixed", data_parallel_devices=2,
                            steps_per_dispatch=SPD),
    }
    # the ranks run in their own processes while JAX runs here
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(W.spawn_ranks, W.dp_window_ranks, 2, (loops,))
        mesh = jdp.make_mesh(2)
        jax_runs = {(name, cap): _jax_window(name, cap, mesh)
                    for name in W.WIN_CASES for cap in W.WIN_CAPS}
        port = ranks.result()
    return port, jax_runs, loops


CASES = [(name, cap) for name in W.WIN_CASES for cap in W.WIN_CAPS]


@pytest.mark.parametrize("name, cap", CASES)
def test_window_matches_jax(runs, name, cap):
    port, jax_runs, _ = runs
    got, want = port[0]["cases"][(name, cap)], jax_runs[(name, cap)]
    assert got["mode"] == "eager"  # gloo on the CPU
    below = cap < 165
    for k in ("loss", "l1", "ssim", "psnr"):
        assert got["metrics"][k].shape == (W.WIN_STEPS,)
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-4, err_msg=k)
    # the true key total, past the capacity when below it
    np.testing.assert_array_equal(got["metrics"]["num_keys"],
                                  want["metrics"]["num_keys"])
    assert (got["metrics"]["num_keys"] > cap).all() == below
    for k in ("feat_mu", "pos_mu"):
        assert np.abs(got["state"][k]).max() > 0, k
        np.testing.assert_allclose(got["state"][k] / (1 - B1),
                                   want["state"][k] / (1 - B1), **GATE)
    _close_params(got["state"], want["state"], W.WIN_STEPS)
    np.testing.assert_array_equal(got["state"]["ctrl_num_in_camera"],
                                  want["state"]["ctrl_num_in_camera"])
    np.testing.assert_array_equal(got["in_camera"], want["in_camera"])
    if name == "pose_window":
        np.testing.assert_array_equal(got["state"]["pose_count"],
                                      want["state"]["pose_count"])
        # row 0 moved once (its -1 step moved nothing), row 1 twice
        np.testing.assert_array_equal(got["state"]["pose_count"], [1, 2])
        assert np.abs(got["state"]["pose_deltas"]
                      - want["state"]["pose_deltas"]).max() \
            <= 2 * W.POSE_LR * W.WIN_STEPS
        np.testing.assert_allclose(got["state"]["pose_mu"] / (1 - B1),
                                   want["state"]["pose_mu"] / (1 - B1),
                                   **GATE)


@pytest.mark.parametrize("name, cap", CASES)
def test_window_equals_its_eager_steps_and_ranks_agree(runs, name, cap):
    port, _, _ = runs
    a, b = port[0]["cases"][(name, cap)], port[1]["cases"][(name, cap)]
    assert a["eager_equal"] and b["eager_equal"]
    for k in a["state"]:
        assert np.array_equal(a["state"][k], b["state"][k]), k
    for k in a["metrics"]:
        assert np.array_equal(a["metrics"][k], b["metrics"][k]), k


@pytest.mark.parametrize("name", W.WIN_CASES)
def test_world_one_window_is_the_single_device_window(name):
    """Without a process group the data-parallel window of one row a step
    is the single-device window on the same f32 targets, bit for bit:
    state, metrics and the last step's statistics."""
    seed, _, _, idx, pose = W.win_case(name)
    config = W.port_config(pose, key_cap=256, **W.WIN_TILE)
    xyz, feats = W.dp_scene(seed=seed)
    state = W.port_state(config, xyz, feats, 2 if pose else 0)
    *views, idxs = W.win_inputs(name, [0])
    dp = make_dp_train_step(config, W.HW, W.HW, device="cpu",
                            scan_steps=W.WIN_STEPS)
    single = ttr.make_train_step(config, W.HW, W.HW, device="cpu",
                                 scan_steps=W.WIN_STEPS)
    s1, m1, fs = dp(state, *views, 3, idxs)
    s2, m2, aux = single(state, *(v[:, 0] for v in views), 3,
                         None if idxs is None else [i[0] for i in idxs])
    for a, b in zip(state_leaves(s1), state_leaves(s2)):
        assert torch.equal(a, b)
    for k in m2:
        assert torch.equal(m1[k], m2[k]), k
    st = aux["stats"]
    assert torch.equal(fs["in_camera"], st.in_camera)
    assert torch.equal(fs["num_affected_pixels"], st.num_affected_pixels)
    assert torch.equal(fs["pred"], aux["pred"])
    if pose:  # the row of the -1 step kept still
        assert s1.pose_opt["count"].tolist() == [0.0, 1.0]


@pytest.mark.parametrize("name", W.WIN_CASES)
def test_replicated_jax_start_state_converts_to_the_ranks(name):
    """``convert.train_state_from_jax`` reads the JAX window's start state
    as the mesh holds it (replicated over two devices, the pose state
    included) and gives the ranks' start state, leaf for leaf."""
    seed, _, _, _, pose = W.win_case(name)
    xyz, feats = W.dp_scene(seed=seed)
    js = jdp.replicate(jdp.make_mesh(2), _jax_state(_jax_config(pose), xyz,
                                                     feats, pose))
    got = train_state_from_jax(js.scene, js.feat_opt[0], js.pos_opt[0],
                               js.ctrl, js.pose_deltas, js.pose_opt,
                               device="cpu")
    want = W.port_state(W.port_config(pose), xyz, feats, 2 if pose else 0)
    for a, b in zip(state_leaves(got), state_leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.fixture(scope="module")
def world4():
    """``dp_window4_ranks`` on four gloo ranks, run in a thread while JAX
    runs the same windows on four devices of the CPU mesh."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(W.spawn_ranks, W.dp_window4_ranks, W.WIN4_WORLD)
        mesh = jdp.make_mesh(W.WIN4_WORLD)
        arrays = tuple(jnp.asarray(v.numpy())
                       for v in W.win4_inputs(range(W.WIN4_WORLD)))
        sharded = jdp.shard_batch(mesh, *arrays, batch_axis=1)
        xyz, feats = W.dp_scene(seed=W.win_case("window")[0])
        jax_runs = {}
        for cap in W.WIN4_CAPS:
            config = dataclasses.replace(_jax_config(False),
                                         rasterisation_config=(
                                             JRasterizerConfig(
                                                 key_cap=cap, interpret=True,
                                                 **W.WIN_TILE)))
            state = jdp.replicate(mesh, _jax_state(config, xyz, feats, False))
            window = jdp.make_dp_train_step(config, W.HW, W.HW, mesh,
                                            scan_steps=W.WIN_STEPS)[0]
            new, metrics, fs = window(state, *sharded,
                                      jnp.asarray(3, jnp.int32))
            jax_runs[cap] = {
                "state": {"features": np.asarray(new.scene.features),
                          "xyz": np.asarray(new.scene.xyz),
                          "feat_mu": np.asarray(new.feat_opt[0].mu),
                          "pos_mu": np.asarray(new.pos_opt[0].mu),
                          "ctrl_num_in_camera": np.asarray(
                              new.ctrl.num_in_camera)},
                "metrics": {k: np.asarray(v) for k, v in metrics.items()},
                "in_camera": np.asarray(fs["in_camera"])}
        return ranks.result(), jax_runs


@pytest.mark.parametrize("cap", W.WIN4_CAPS)
def test_window_of_four_ranks_matches_jax(world4, cap):
    """A window of 2 steps on four gloo ranks, a camera each a step,
    against JAX's ``make_dp_train_step(scan_steps=2)`` on four devices of
    the CPU mesh, at a capacity above and below the views' key totals, in
    the gates of the two-rank cases; the four ranks bit-identical."""
    port, jax_runs = world4
    got, want = port[0][cap], jax_runs[cap]
    assert (got["mode"], got["world"]) == ("eager", W.WIN4_WORLD)
    for k in ("loss", "l1", "ssim", "psnr"):
        assert got["metrics"][k].shape == (W.WIN_STEPS,)
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["metrics"]["num_keys"],
                                  want["metrics"]["num_keys"])
    assert (got["metrics"]["num_keys"] > cap).any() == (cap < 165)
    for k in ("feat_mu", "pos_mu"):
        assert np.abs(got["state"][k]).max() > 0, k
        np.testing.assert_allclose(got["state"][k] / (1 - B1),
                                   want["state"][k] / (1 - B1), **GATE)
    _close_params(got["state"], want["state"], W.WIN_STEPS)
    np.testing.assert_array_equal(got["state"]["ctrl_num_in_camera"],
                                  want["state"]["ctrl_num_in_camera"])
    np.testing.assert_array_equal(got["in_camera"], want["in_camera"])
    for other in port[1:]:
        for k in got["state"]:
            assert np.array_equal(got["state"][k], other[cap]["state"][k]), k


def _jax_draw(config_dict, num_items, res, world=2):
    """The JAX trainer's data-parallel draw (trainer.py:775-839, outside
    multihost): (steps, global indices) of each dispatch, from its loader's
    index stream and its window schedule."""
    jt = jtr.GaussianPointCloudTrainer.__new__(jtr.GaussianPointCloudTrainer)
    jt.config = jax_from_dict(config_dict)
    stream = jds.PrefetchLoader(list(range(num_items)),
                                seed=config_dict.get("seed", 0))._index_stream()
    out, it = [], -1
    while it + 1 < config_dict["num_iterations"]:
        it += 1
        window = jt._window_size(it)
        items = [next(stream) for _ in range(world * window)]
        hw = res[items[-1]]
        if any(res[i] != hw for i in items):
            window = 1
            items = [i for i in items if res[i] == hw][-world:]
            while len(items) < world:
                i = next(stream)
                if res[i] == hw:
                    items.append(i)
        out.append((window, items))
        it += window - 1
    return out


def test_trainer_draw_matches_jax(runs):
    """Each rank's cameras of each dispatch are its slice of the JAX
    trainer's draw for the same seed, dispatch by dispatch, windows and
    mixed-resolution fallbacks alike."""
    port, _, loops = runs
    for name in ("windows", "mixed"):
        cfg = loops[name]
        recs = json.loads(Path(cfg["train_dataset_json_path"]).read_text())
        res = [jmh.expected_resolution(r, 32) for r in recs]
        want = _jax_draw(cfg, len(recs), res)
        for rank in (0, 1):
            got = port[rank][name]["draws"]
            assert [s for s, _ in got] == [s for s, _ in want], name
            assert [idx for _, idx in got] == [
                jmh.GlobalShuffleSampler.local_slice(g, 2, 1, rank)
                for _, g in want], (name, rank)
    mixed = [s for s, _ in port[0]["mixed"]["draws"]]
    windows = [s for s, _ in port[0]["windows"]["draws"]]
    # the schedule's windows ran on the uniform views; on the mixed ones
    # the same schedule fell back to single steps
    assert windows == [1, SPD, SPD, 1, 1, 1]
    assert SPD not in mixed and len(mixed) == LOOP["num_iterations"]


def test_trainer_windows_follow_the_schedule_and_refit_at_zero(runs):
    port, _, loops = runs
    tt = ttr.GaussianPointCloudTrainer.__new__(ttr.GaussianPointCloudTrainer)
    tt.config = from_dict(loops["windows"])
    it, sched = 0, []
    while it < LOOP["num_iterations"]:
        sched.append(tt._window_size(it))
        it += sched[-1]
    for rank in (0, 1):
        run = port[rank]["windows"]
        assert [s for s, _ in run["draws"]] == sched
        # the refit ran at 0, on the window end's key total, and kept 4096
        assert len(run["refits"]) == 1 and run["refits"][0][1] == 4096
        assert 0 < run["refits"][0][0] < 4096 and run["key_cap"] == 4096
        # capped steps and windows of 4 at 64x64; spd 1 sizes exactly
        assert run["step_cache"] == [(64, 64, 4096, 0), (64, 64, 4096, SPD)]
    assert port[0]["singles"]["step_cache"] == [(64, 64)]


def test_trainer_ranks_agree_and_windows_end_where_single_steps_end(runs):
    """The two ranks end bit-identical, and the loop with windows ends
    bit for bit where the loop of single data-parallel steps ends: no key
    was dropped, and both stage f32 targets."""
    port, _, _ = runs
    for name in ("windows", "singles", "mixed"):
        a, b = port[0][name]["leaves"], port[1][name]["leaves"]
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
    w, s = port[0]["windows"]["leaves"], port[0]["singles"]["leaves"]
    assert len(w) == len(s)
    for x, y in zip(w, s):
        assert np.array_equal(x, y)
    assert int(w[6]) == LOOP["num_iterations"]  # the feature Adam's count


@pytest.mark.parametrize("dev, backend, world, mode", [
    ("cpu", None, 1, "eager"),
    ("cpu", "gloo", 2, "eager"),
    ("cuda", None, 1, "graph"),
    ("cuda", "nccl", 1, "graph"),
    ("cuda", "nccl", 4, "graph"),
    ("cuda", "gloo", 2, "eager"),
])
def test_window_mode_follows_the_backend(monkeypatch, dev, backend, world,
                                         mode):
    """The one rule of how a window runs: a graph on a card with no group
    or in an NCCL group of any size; eager on the CPU and over gloo."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: backend is not None)
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: world)
    assert ttr.window_mode(torch.device(dev)) == mode
