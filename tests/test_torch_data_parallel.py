"""The port's data-parallel step (``parallel/data_parallel.py``) on two
gloo ranks on the CPU, against the JAX package's ``make_dp_train_step``
on two devices of the CPU mesh, and against the port's single-device step,
in the cases of tests/test_parallel.py (32x32 views, 96 points).

Gates: losses at rtol 1e-4 (the mean of the per-camera losses at rtol
1e-5); gradients (Adam's first ``mu`` / (1 - b1)) at the gradient gate,
atol 5e-4, rtol 1e-3; parameters after the Adam step within 2 lr of
JAX's, 1e-6 at the median (a noise-level gradient whose sign differs
moves Adam by +-lr); the densify statistics as
tests/test_torch_rasterizer_stats.py (JAX truncates them to bf16): counts
and visibility exact, sums at rtol 8e-3; pose rows within 2 lr of JAX's.
Against the port's own single-device step the identical-camera batch is
exact: a mean of two equal gradients is the gradient. The two ranks'
replicated states are bit-identical.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.models.scene import GaussianScene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (  # noqa: E402
    RasterizerConfig as JRasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu.parallel import data_parallel as jdp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import controller as jc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    TrainConfig as JTrainConfig,
)
from taichi_3d_gaussian_splatting_tpu.training.loss import (  # noqa: E402
    LossConfig as JLossConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as tc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from tests import torch_dist_workers as W  # noqa: E402

GATE = dict(atol=5e-4, rtol=1e-3)
B1 = 0.9


def _jax_config(pose):
    config = JTrainConfig(
        rasterisation_config=JRasterizerConfig(tile_size=32, key_cap=2048,
                                               interpret=True),
        loss_function_config=JLossConfig(enable_regularization=False),
        feature_learning_rate=1e-2)
    if pose:
        config = dataclasses.replace(config, pose_refinement=True,
                                     pose_learning_rate=W.POSE_LR,
                                     pose_refinement_warm_up=0)
    return config


def _jax_state(config, xyz, feats, pose):
    n = len(xyz)
    scene = GaussianScene(xyz=jnp.asarray(xyz), features=jnp.asarray(feats),
                          invalid=jnp.zeros(n, bool),
                          object_id=jnp.zeros(n, jnp.int32))
    ftx, ptx = jtr.make_optimizers(config)
    extra = {}
    if pose:
        extra = dict(pose_deltas=jnp.zeros((2, 6), jnp.float32),
                     pose_opt=jtr.init_pose_opt(2))
    return jtr.TrainState(scene=scene, feat_opt=ftx.init(scene.features),
                          pos_opt=ptx.init(scene.xyz),
                          ctrl=jc.init_state(n), **extra)


def _jax_case(name, mesh, steps):
    seed, imgs, ts, idx, pose = W.dp_case(name)
    config = _jax_config(pose)
    if pose not in steps:
        steps[pose] = jdp.make_dp_train_step(config, W.HW, W.HW, mesh)[0]
    xyz, feats = W.dp_scene(seed=seed)
    state = jdp.replicate(mesh, _jax_state(config, xyz, feats, pose))
    arrays = (np.stack(imgs), np.stack([W.Q_ID] * 2), np.stack(ts),
              np.stack([W.K32] * 2))
    if pose:
        arrays = arrays + (np.asarray(idx, np.int32),)
    sharded = jdp.shard_batch(mesh, *(jnp.asarray(a) for a in arrays))
    new, metrics, fs = steps[pose](state, *sharded[:4],
                                   jnp.asarray(3, jnp.int32), *sharded[4:])
    out = {"features": new.scene.features, "xyz": new.scene.xyz,
           "feat_mu": new.feat_opt[0].mu, "pos_mu": new.pos_opt[0].mu}
    out.update({f"ctrl_{f}": getattr(new.ctrl, f)
                for f in new.ctrl._fields})
    if pose:
        out["pose_deltas"] = new.pose_deltas
        out.update({f"pose_{k}": v for k, v in new.pose_opt.items()})
    return {"state": {k: np.asarray(v) for k, v in out.items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "frame_stats": {k: np.asarray(v) for k, v in fs.items()}}


@pytest.fixture(scope="module")
def runs():
    port = W.spawn_ranks(W.dp_ranks)
    mesh = jdp.make_mesh(2)
    steps = {}
    jax_runs = {name: _jax_case(name, mesh, steps) for name in W.DP_CASES}
    return port, jax_runs


def _single(name, row):
    """The port's single-device step on one row of a case."""
    seed, imgs, ts, idx, pose = W.dp_case(name)
    config = W.port_config(pose)
    xyz, feats = W.dp_scene(seed=seed)
    state = W.port_state(config, xyz, feats, 2 if pose else 0)
    step = ttr.make_train_step(config, W.HW, W.HW, device="cpu")
    new, metrics, aux = step(
        state, torch.from_numpy(imgs[row]), torch.from_numpy(W.Q_ID),
        torch.from_numpy(ts[row]), torch.from_numpy(W.K32), 3,
        -1 if idx is None else idx[row])
    return new, metrics, aux


def _close_params(got, want, lr_scale=1.0):
    for name, lr in (("features", 1e-2), ("xyz", 1e-5)):
        d = np.abs(got[name] - want[name])
        assert np.isfinite(d).all(), name
        assert d.max() <= 2 * lr * lr_scale, (name, d.max())
        assert np.median(d) <= 1e-6, (name, np.median(d))


def _grads_match(got, want):
    for k in ("feat_mu", "pos_mu"):
        assert np.abs(got[k]).max() > 0, k
        np.testing.assert_allclose(got[k] / (1 - B1), want[k] / (1 - B1),
                                   **GATE)


def test_ranks_hold_bit_identical_states(runs):
    port, _ = runs
    for name in W.DP_CASES:
        a, b = port[0][name]["state"], port[1][name]["state"]
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (name, k)
        assert port[0][name]["metrics"] == port[1][name]["metrics"]
    # one packed SUM and one packed MAX a step (and the pose SUM)
    assert [op for op, _ in port[0]["identical"]["collectives"]] == [
        "sum", "max"]
    assert [op for op, _ in port[0]["pose_rows"]["collectives"]] == [
        "sum", "max", "sum"]


def test_identical_cameras_match_single_device(runs):
    port, jax_runs = runs
    got, want = port[0]["identical"], jax_runs["identical"]
    s1, m1, _ = _single("identical", 0)
    single = W.state_np(s1)
    # against the port's single-device step: exactly
    for k in ("features", "xyz", "feat_mu", "pos_mu"):
        np.testing.assert_array_equal(got["state"][k], single[k])
    np.testing.assert_array_equal(got["state"]["ctrl_num_in_camera"],
                                  2 * single["ctrl_num_in_camera"])
    assert got["metrics"]["loss"] == float(m1["loss"])
    # against JAX's data-parallel step
    for k in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-4)
    _grads_match(got["state"], want["state"])
    _close_params(got["state"], want["state"])
    np.testing.assert_array_equal(got["state"]["ctrl_num_in_camera"],
                                  want["state"]["ctrl_num_in_camera"])


def test_different_cameras_average_gradients(runs):
    port, jax_runs = runs
    got, want = port[0]["different"], jax_runs["different"]
    (_, ma, _), (_, mb, _) = _single("different", 0), _single("different", 1)
    np.testing.assert_allclose(
        got["metrics"]["loss"], (float(ma["loss"]) + float(mb["loss"])) / 2,
        rtol=1e-5)
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=1e-4)
    _grads_match(got["state"], want["state"])
    _close_params(got["state"], want["state"])


def test_densify_selection_matches_single_device(runs):
    port, jax_runs = runs
    fs, jfs = port[0]["identical"]["frame_stats"], jax_runs["identical"][
        "frame_stats"]
    s1, _, aux1 = _single("identical", 0)
    st = aux1["stats"]
    # identical cameras: the frame stats are the single camera's
    np.testing.assert_array_equal(fs["in_camera"], st.in_camera.numpy())
    vis = st.in_camera.numpy()
    for k, v in (("num_affected_pixels", st.num_affected_pixels),
                 ("magnitude_grad_viewspace", st.magnitude_grad_viewspace),
                 ("grad_uv", st.grad_uv)):
        np.testing.assert_array_equal(fs[k][vis], v.numpy()[vis])
    np.testing.assert_array_equal(fs["point_depth"][vis],
                                  aux1["point_depth"].numpy()[vis])
    # and JAX's
    np.testing.assert_array_equal(fs["in_camera"], jfs["in_camera"])
    np.testing.assert_array_equal(fs["num_overlap_tiles"],
                                  jfs["num_overlap_tiles"])
    for k in ("num_affected_pixels", "magnitude_grad_viewspace"):
        np.testing.assert_allclose(fs[k], jfs[k], rtol=8e-3, atol=0)
    np.testing.assert_allclose(fs["grad_uv"], jfs["grad_uv"], **GATE)
    np.testing.assert_allclose(fs["point_depth"][vis],
                               jfs["point_depth"][vis], rtol=1e-6)

    # the selection, with thresholds low enough that points fire
    ccfg = tc.ControllerConfig(
        densification_view_space_position_gradients_threshold=1e-7,
        under_reconstructed_num_pixels_threshold=8)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    dp_state = port[0]["identical"]["state"]
    ctrl_dp = tc.ControllerState(*(t(dp_state[f"ctrl_{f}"])
                                   for f in tc.ControllerState._fields))
    scene_dp = s1.scene._replace(features=t(dp_state["features"]),
                                 xyz=t(dp_state["xyz"]))
    info1 = tc.find_densify(s1.scene, s1.ctrl, st.in_camera,
                            st.num_affected_pixels,
                            st.magnitude_grad_viewspace,
                            aux1["point_depth"], True, ccfg)
    info2 = tc.find_densify(scene_dp, ctrl_dp, t(fs["in_camera"]),
                            t(fs["num_affected_pixels"]),
                            t(fs["magnitude_grad_viewspace"]),
                            t(fs["point_depth"]), True, ccfg)
    assert int(info1.densify_mask.sum()) > 0, "the thresholds select nothing"
    for f in ("densify_mask", "remove_mask", "over_mask"):
        np.testing.assert_array_equal(getattr(info1, f).numpy(),
                                      getattr(info2, f).numpy())


def test_accumulators_sum_per_camera_gradients(runs):
    port, jax_runs = runs
    got, want = port[0]["different"]["state"], jax_runs["different"]["state"]
    sa, _, _ = _single("different", 0)
    sb, _, _ = _single("different", 1)
    for f in ("grad_position", "grad_position_norm"):
        np.testing.assert_allclose(
            got[f"ctrl_{f}"], getattr(sa.ctrl, f).numpy()
            + getattr(sb.ctrl, f).numpy(), rtol=2e-4, atol=1e-10)
        np.testing.assert_allclose(got[f"ctrl_{f}"], want[f"ctrl_{f}"],
                                   rtol=8e-3, atol=5e-4)
    np.testing.assert_array_equal(got["ctrl_num_in_camera"],
                                  want["ctrl_num_in_camera"])
    for f in ("num_pixels", "grad_viewspace", "grad_viewspace_avg"):
        np.testing.assert_allclose(got[f"ctrl_{f}"], want[f"ctrl_{f}"],
                                   rtol=8e-3, atol=0)


def test_pose_rows_match_single_device(runs):
    port, jax_runs = runs
    got, want = port[0]["pose_rows"]["state"], jax_runs["pose_rows"]["state"]
    s1, _, _ = _single("pose_rows", 0)
    d1 = s1.pose_deltas.numpy()
    assert np.abs(d1[0]).max() > 0, "the single-device pose never moved"
    # each row's update is its own camera's, never batch-averaged
    np.testing.assert_allclose(got["pose_deltas"][0], d1[0], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_allclose(got["pose_deltas"][1], d1[0], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_array_equal(got["pose_count"], [1.0, 1.0])
    np.testing.assert_array_equal(got["xyz"], s1.scene.xyz.numpy())
    # and JAX's
    np.testing.assert_array_equal(got["pose_count"], want["pose_count"])
    assert np.abs(got["pose_deltas"] - want["pose_deltas"]).max() \
        <= 2 * W.POSE_LR
    np.testing.assert_allclose(got["pose_mu"] / (1 - B1),
                               want["pose_mu"] / (1 - B1), **GATE)


def test_duplicate_index_sums_to_one_update(runs):
    port, jax_runs = runs
    got, want = port[0]["duplicate"]["state"], jax_runs["duplicate"]["state"]
    np.testing.assert_array_equal(got["pose_count"], [1.0, 0.0])
    assert np.abs(got["pose_deltas"][1]).max() == 0.0
    # two equal rows average into the single camera's gradient
    s1, _, _ = _single("pose_rows", 0)
    np.testing.assert_allclose(got["pose_deltas"][0],
                               s1.pose_deltas.numpy()[0], rtol=1e-4,
                               atol=1e-9)
    np.testing.assert_array_equal(got["pose_count"], want["pose_count"])
    np.testing.assert_allclose(got["pose_mu"] / (1 - B1),
                               want["pose_mu"] / (1 - B1), **GATE)
