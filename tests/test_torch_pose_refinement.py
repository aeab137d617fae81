"""Pose refinement in the port's training step and loop, against the JAX
package's ``make_train_step`` and its trainer's refined-pose export.

Gates, as tests/test_torch_train_step.py: loss, l1, ssim and psnr at rtol
1e-4 on every step; the first pose gradient of each view (JAX's is its
Adam ``mu`` / (1 - b1) after that view's first update) at the gradient gate
(atol 5e-4, rtol 1e-3); the per-row Adam counts exactly; the pose deltas
within 2 lr a refining step of each other (a noise-level gradient whose
sign differs moves Adam by +-lr). The refined-pose files are equal as
JSON: both are numpy and scipy on the same f32 deltas.
"""
import dataclasses
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.models.scene import GaussianScene  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops.rasterizer import (  # noqa: E402
    RasterizerConfig as JRasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu.training import controller as jc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    TrainConfig as JTrainConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.convert import (  # noqa: E402
    train_state_from_jax,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (  # noqa: E402
    quaternion_exp,
    quaternion_multiply,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint as ck  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (  # noqa: E402
    TrainConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (  # noqa: E402
    LossConfig,
)
from tests.test_torch_train_step import _pool  # noqa: E402
from tests.torch_port_scenes import (  # noqa: E402
    K32,
    Q_ID,
    T_ID,
    make_K,
    make_train_scene,
)

STEPS = 10
WARM = 2  # steps before the poses move
LR = 5e-3
GATE = dict(atol=5e-4, rtol=1e-3)
METRICS = ("loss", "l1", "ssim", "psnr")


def _views():
    """Two camera poses off the identity by a seeded small turn and shift."""
    rng = np.random.default_rng(4)
    out = []
    for _ in range(2):
        w = rng.uniform(-0.03, 0.03, 3).astype(np.float32)
        q = quaternion_multiply(torch.from_numpy(Q_ID),
                                quaternion_exp(torch.from_numpy(w))).numpy()
        out.append((q, rng.uniform(-0.04, 0.04, 3).astype(np.float32)))
    return out


def _idx(step):
    return -1 if step < WARM else step % 2


@pytest.fixture(scope="module")
def runs():
    xyz, feats, invalid = _pool()
    n = len(xyz)
    jconfig = JTrainConfig(
        rasterisation_config=JRasterizerConfig(tile_size=32, key_cap=4096,
                                               interpret=True),
        pose_refinement=True, pose_learning_rate=LR)
    scene = GaussianScene(xyz=jnp.asarray(xyz), features=jnp.asarray(feats),
                          invalid=jnp.asarray(invalid),
                          object_id=jnp.zeros((n,), jnp.int32))
    ftx, ptx = jtr.make_optimizers(jconfig)
    js = jtr.TrainState(scene=scene, feat_opt=ftx.init(scene.features),
                        pos_opt=ptx.init(scene.xyz), ctrl=jc.init_state(n),
                        pose_deltas=jnp.zeros((2, 6), jnp.float32),
                        pose_opt=jtr.init_pose_opt(2))
    ts = train_state_from_jax(
        js.scene, js.feat_opt[0], js.pos_opt[0], js.ctrl,
        pose_deltas=np.asarray(js.pose_deltas),
        pose_opt={k: np.asarray(v) for k, v in js.pose_opt.items()},
        device="cpu")
    gt = (np.random.default_rng(2).random((64, 64, 3)) * 255).astype(np.uint8)
    jstep = jtr.make_train_step(jconfig, 64, 64)
    tstep = ttr.make_train_step(
        TrainConfig(rasterisation_config=tr.RasterizerConfig(tile_size=32),
                    pose_refinement=True, pose_learning_rate=LR),
        64, 64, device="cpu")
    views = _views()
    out = {"j": [], "t": []}
    for i in range(STEPS):
        q, t = views[i % 2]
        js, jm, _ = jstep(js, *(jnp.asarray(a) for a in (gt, q, t, make_K())),
                          jnp.asarray(3, jnp.int32),
                          jnp.asarray(_idx(i), jnp.int32))
        ts, tm, ta = tstep(
            ts, *(torch.from_numpy(a) for a in (gt, q, t, make_K())), 3,
            _idx(i))
        # the JAX step donates its input state: keep numpy copies
        snap = {"pose_deltas": np.asarray(js.pose_deltas),
                **{k: np.asarray(v) for k, v in js.pose_opt.items()}}
        out["j"].append((snap, jm))
        out["t"].append((ts, tm, ta))
    return out


def test_pose_refining_steps_match_jax(runs):
    for (_, jm), (_, tm, _) in zip(runs["j"], runs["t"]):
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    for i in (WARM, WARM + 1):  # each view's first refining step
        jsnap, (_, _, ta) = runs["j"][i][0], runs["t"][i]
        got = ta["grad_pose"].numpy()
        want = jsnap["mu"][_idx(i)] / 0.1
        assert np.isfinite(got).all() and np.abs(got).max() > 1e-4
        np.testing.assert_allclose(got, want, **GATE)
        assert np.isfinite(ta["grad_q"].numpy()).all()
        assert np.isfinite(ta["grad_t"].numpy()).all()
    jsnap, ts = runs["j"][-1][0], runs["t"][-1][0]
    np.testing.assert_array_equal(ts.pose_opt["count"].numpy(),
                                  jsnap["count"])
    assert ts.pose_opt["count"].numpy().tolist() == [4.0, 4.0]
    d = np.abs(ts.pose_deltas.numpy() - jsnap["pose_deltas"])
    assert d.max() <= 2 * LR * 4, d.max()
    assert np.abs(ts.pose_deltas.numpy()).max() > 0.5 * LR


def test_warm_up_leaves_the_poses_at_zero(runs):
    for i in range(WARM):
        ts, _, ta = runs["t"][i]
        assert float(ts.pose_deltas.abs().max()) == 0.0
        assert float(ts.pose_opt["count"].abs().max()) == 0.0
        # the pose cotangent is computed, as the JAX step computes it, and
        # the masked update moves no row
        assert "grad_pose" in ta
        assert np.abs(runs["j"][i][0]["pose_deltas"]).max() == 0.0
    # each refining step moves its own view's row alone
    before = runs["t"][WARM - 1][0].pose_deltas
    after = runs["t"][WARM][0].pose_deltas
    row = _idx(WARM)
    assert float((after[row] - before[row]).abs().max()) > 0
    assert torch.equal(after[1 - row], before[1 - row])


def test_checkpoint_round_trips_the_pose_state(runs, tmp_path):
    state = runs["t"][-1][0]
    ck.save_checkpoint(str(tmp_path / "ck"), state, {"iteration": 9})
    template = ttr.init_train_state(state.scene, TrainConfig(
        pose_refinement=True), num_train_images=2)
    restored, meta = ck.load_checkpoint(str(tmp_path / "ck"), template)
    assert meta["iteration"] == 9 and meta["num_leaves"] == 20
    for a, b in zip(ck.state_leaves(restored), ck.state_leaves(state)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert sorted(restored.pose_opt) == ["count", "mu", "nu"]
    with pytest.raises(ValueError, match="leaves"):
        ck.load_checkpoint(str(tmp_path / "ck"), template._replace(
            pose_deltas=None, pose_opt=None))


def _export(module, state, records, out_dir):
    """refined_poses.json of ``module``'s trainer for ``state``, read back
    (the method needs only the train records and the output directory)."""
    stub = type("Stub", (), {})()
    stub.train_dataset = type("Records", (), {"records": records})()
    stub.output_model_dir = str(out_dir)
    out_dir.mkdir()
    module.GaussianPointCloudTrainer._export_refined_poses(stub, state)
    return json.loads((out_dir / "refined_poses.json").read_text())


def test_refined_poses_json_matches_jax(runs, tmp_path):
    rng = np.random.default_rng(6)
    records = []
    for i in range(2):
        T = np.eye(4)
        T[:3, 3] = rng.normal(size=3)
        records.append({"image_path": f"{i}.png", "camera_id": 0,
                        "T_pointcloud_camera": T.tolist()})
    ts = runs["t"][-1][0]
    got = _export(ttr, ts, records, tmp_path / "port")
    # the JAX trainer's export of the same deltas
    want = _export(jtr, jtr.TrainState(
        None, None, None, None,
        pose_deltas=jnp.asarray(ts.pose_deltas.numpy())), records,
        tmp_path / "jax")
    assert got == want
    assert [r["image_path"] for r in got] == ["0.png", "1.png"]
    moved = np.asarray(got[0]["T_pointcloud_camera"])
    assert np.abs(moved - np.asarray(records[0]["T_pointcloud_camera"])
                  ).max() > 0
    # the JAX run's own deltas give poses within their gap
    jrun = _export(jtr, jtr.TrainState(
        None, None, None, None,
        pose_deltas=jnp.asarray(runs["j"][-1][0]["pose_deltas"])), records,
        tmp_path / "jax_run")
    for a, b in zip(got, jrun):
        np.testing.assert_allclose(np.asarray(a["T_pointcloud_camera"]),
                                   np.asarray(b["T_pointcloud_camera"]),
                                   atol=2 * (2 * LR * 4))


def _padded_scene(pad=16):
    xyz, feats, invalid = make_train_scene(seed=4)
    return [torch.from_numpy(a) for a in (
        np.concatenate([xyz, np.zeros((pad, 3), np.float32)]),
        np.concatenate([feats, np.zeros((pad, 56), np.float32)]),
        np.concatenate([invalid, np.ones((pad,), bool)]))]


def test_pose_refinement_recovers_perturbed_camera():
    """tests/test_training.py::test_pose_refinement_recovers_perturbed_camera
    on the port: with the scene frozen, the per-view se(3) delta undoes a
    pose perturbation, over zero-padded invalid slots whose NaN Jacobians
    must not reach the pose gradient; a warm-up step (-1) moves nothing."""
    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        scene_from_jax_arrays,
    )

    config = TrainConfig(
        rasterisation_config=tr.RasterizerConfig(tile_size=32),
        loss_function_config=LossConfig(enable_regularization=False),
        feature_learning_rate=1e-8, position_learning_rate=1e-8,
        pose_refinement=True, pose_learning_rate=5e-3)
    xyz, feats, invalid = _padded_scene()
    scene = scene_from_jax_arrays(xyz.numpy(), feats.numpy(), invalid.numpy(),
                                  device="cpu")
    K = torch.from_numpy(K32)
    cam = tr.Camera(K, 32, 32)
    q_id, t_id = torch.from_numpy(Q_ID), torch.from_numpy(T_ID)
    target = torch.clamp(tr.rasterize(xyz, feats, invalid, q_id, t_id, cam,
                                      config.rasterisation_config).rgb, 0, 1)
    w0 = torch.tensor([0.02, -0.03, 0.01])
    dt0 = torch.tensor([0.02, -0.015, 0.03])
    q_pert = quaternion_multiply(q_id, quaternion_exp(w0))
    step = ttr.make_train_step(config, 32, 32, device="cpu")
    state = ttr.init_train_state(scene, config, num_train_images=1)
    losses = []
    for _ in range(80):
        state, metrics, aux = step(state, target, q_pert, dt0, K, 3, 0)
        losses.append(float(metrics["loss"]))
        assert bool(torch.isfinite(aux["grad_pose"]).all())
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < 0.4 * np.mean(losses[:3]), losses[::10]
    d = state.pose_deltas[0].numpy()
    assert np.dot(d[:3], -w0.numpy()) > 0
    assert np.dot(d[3:], -dt0.numpy()) > 0
    before = state.pose_deltas.clone()
    state, _, _ = step(state, target, q_pert, dt0, K, 3, -1)
    assert torch.equal(state.pose_deltas, before)


def test_step_without_refinement_ignores_the_index():
    """Without pose_refinement the state has no pose leaves and the view
    index changes nothing."""
    xyz, feats, invalid = _padded_scene()
    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        scene_from_jax_arrays,
    )
    config = dataclasses.replace(TrainConfig(), rasterisation_config=(
        tr.RasterizerConfig(tile_size=32)))
    scene = scene_from_jax_arrays(xyz.numpy(), feats.numpy(), invalid.numpy(),
                                  device="cpu")
    state = ttr.init_train_state(scene, config, num_train_images=3)
    assert state.pose_deltas is None and state.pose_opt is None
    step = ttr.make_train_step(config, 32, 32, device="cpu")
    args = (torch.zeros((32, 32, 3)), torch.from_numpy(Q_ID),
            torch.from_numpy(T_ID), torch.from_numpy(K32), 3)
    a = step(state, *args)[0]
    b = step(state, *args, 2)[0]
    assert torch.equal(a.scene.features, b.scene.features)
    assert a.pose_deltas is None and len(ck.state_leaves(a)) == 16


def test_loop_refines_poses_and_resumes(tmp_path):
    """The training loop under pose_refinement: no row moves during the
    pose warm-up, each later iteration moves its view's row once, the
    validation writes refined_poses.json, and a resume restores the pose
    state."""
    from tests.test_torch_train_loop import (
        ITERS,
        _config_dict,
        write_dataset,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )

    (tmp_path / "data").mkdir()
    dataset = write_dataset(tmp_path / "data")
    over = dict(pose_refinement=True, pose_refinement_warm_up=3,
                pose_learning_rate=1e-3)
    trainer = ttr.GaussianPointCloudTrainer(from_dict(_config_dict(
        dataset, tmp_path / "logs", **over)), device="cpu")
    state = trainer.train()
    assert state.pose_deltas.shape == (3, 6)
    assert float(state.pose_opt["count"].sum()) == ITERS - 3
    moved = state.pose_opt["count"] > 0
    assert bool((state.pose_deltas[moved].abs().sum(1) > 0).all())
    assert float(state.pose_deltas[~moved].abs().sum()) == 0.0
    recs = json.loads((tmp_path / "logs" / "refined_poses.json").read_text())
    assert len(recs) == 3 and all("image_path" in r for r in recs)
    resumed = ttr.GaussianPointCloudTrainer(from_dict(_config_dict(
        dataset, tmp_path / "logs2", num_iterations=ITERS,
        resume_from=str(tmp_path / "logs" / "checkpoint_latest"), **over)),
        device="cpu")
    restored = resumed.train()
    saved = ck.load_checkpoint(str(tmp_path / "logs" / "checkpoint_latest"),
                               restored)[0]
    assert torch.equal(restored.pose_deltas, saved.pose_deltas)
    for k in ("mu", "nu", "count"):
        assert torch.equal(restored.pose_opt[k], saved.pose_opt[k])
