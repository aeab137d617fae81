"""The port's train step against the JAX package's ``make_train_step``:
the same state, made with numpy and carried across by
``convert.train_state_from_jax``, and the same uint8 target, for 10 steps.

Gates: loss, l1, ssim and psnr at rtol 1e-4 on every step; step 1's
gradients at the gradient gate (atol 5e-4, rtol 1e-3); the parameters
after 1 and after 10 steps within 2 lr a step of each other at most and
1e-6 at the median (a noise-level gradient whose sign differs moves Adam by
+-lr); ``ControllerState.num_in_camera`` exactly, the rest at rtol 8e-3
(JAX truncates the densify statistics to bf16), with the gradient gate's
atol for the sums of position gradients.
"""
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
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (  # noqa: E402
    RasterizerConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (  # noqa: E402
    TrainConfig,
)
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

STEPS = 10
GATE = dict(atol=5e-4, rtol=1e-3)
METRICS = ("loss", "l1", "ssim", "psnr")


def _pool():
    """make_scene's pool with points behind the camera and zero-padded
    invalid slots appended."""
    xyz, feats, invalid = make_scene(160, seed=5)
    xyz[8:16, 2] *= -1.0
    pad = 8
    return (np.concatenate([xyz, np.zeros((pad, 3), np.float32)]),
            np.concatenate([feats, np.zeros((pad, 56), np.float32)]),
            np.concatenate([invalid, np.ones((pad,), bool)]))


@pytest.fixture(scope="module")
def runs():
    xyz, feats, invalid = _pool()
    n = len(xyz)
    jconfig = JTrainConfig(rasterisation_config=JRasterizerConfig(
        tile_size=32, key_cap=4096, interpret=True))
    scene = GaussianScene(xyz=jnp.asarray(xyz), features=jnp.asarray(feats),
                          invalid=jnp.asarray(invalid),
                          object_id=jnp.zeros((n,), jnp.int32))
    ftx, ptx = jtr.make_optimizers(jconfig)
    js = jtr.TrainState(scene=scene, feat_opt=ftx.init(scene.features),
                        pos_opt=ptx.init(scene.xyz), ctrl=jc.init_state(n))
    ts = train_state_from_jax(js.scene, js.feat_opt[0], js.pos_opt[0],
                              js.ctrl, device="cpu")
    gt = (np.random.default_rng(2).random((64, 64, 3)) * 255).astype(np.uint8)
    jstep = jtr.make_train_step(jconfig, 64, 64)
    tstep = ttr.make_train_step(
        TrainConfig(rasterisation_config=RasterizerConfig(tile_size=32)), 64,
        64, device="cpu")
    jargs = [jnp.asarray(a) for a in (gt, Q_ID, T_ID, make_K())]
    targs = [torch.from_numpy(a) for a in (gt, Q_ID, T_ID, make_K())]
    out = {"j": [], "t": []}
    for _ in range(STEPS):
        js, jm, ja = jstep(js, *jargs, jnp.asarray(3, jnp.int32))
        ts, tm, ta = tstep(ts, *targs, 3)
        # the JAX step donates its input state: keep numpy copies
        snap = {"features": np.asarray(js.scene.features),
                "xyz": np.asarray(js.scene.xyz),
                "ctrl": {f: np.asarray(getattr(js.ctrl, f))
                         for f in js.ctrl._fields}}
        out["j"].append((snap, jm, ja))
        out["t"].append((ts, tm, ta))
    return out


def _close_params(t_state, j_snap, steps):
    for name, lr in (("features", 1e-3), ("xyz", 1e-5)):
        d = np.abs(getattr(t_state.scene, name).numpy() - j_snap[name])
        assert np.isfinite(d).all(), name
        assert d.max() <= 2 * lr * steps, (name, d.max())
        assert np.median(d) <= 1e-6, (name, np.median(d))


def test_first_step_matches_jax(runs):
    (js, jm, ja), (ts, tm, ta) = runs["j"][0], runs["t"][0]
    assert tm["num_keys"] == int(jm["num_keys"]) > 0
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    for k in ("grad_features", "grad_xyz"):
        got, want = ta[k].numpy(), np.asarray(ja[k])
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, **GATE)
    np.testing.assert_allclose(ta["pred"].numpy(), np.asarray(ja["pred"]),
                               rtol=0, atol=1e-4)
    _close_params(ts, js, 1)


def test_ten_steps_match_jax(runs):
    for (js, jm, _), (ts, tm, _) in zip(runs["j"], runs["t"]):
        for k in METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
    js, ts = runs["j"][-1][0], runs["t"][-1][0]
    assert ts.feat_opt.count == ts.pos_opt.count == STEPS
    _close_params(ts, js, STEPS)
    losses = [float(m["loss"]) for _, m, _ in runs["t"]]
    assert losses[-1] < losses[0]


def test_controller_state_matches_jax(runs):
    jctrl, tctrl = runs["j"][-1][0]["ctrl"], runs["t"][-1][0].ctrl
    np.testing.assert_array_equal(tctrl.num_in_camera.numpy(),
                                  jctrl["num_in_camera"])
    assert float(tctrl.num_in_camera.max()) == STEPS
    for f in ("num_pixels", "grad_viewspace", "grad_viewspace_avg"):
        np.testing.assert_allclose(getattr(tctrl, f).numpy(), jctrl[f],
                                   rtol=8e-3, atol=0)
    for f in ("grad_position", "grad_position_norm"):
        np.testing.assert_allclose(getattr(tctrl, f).numpy(), jctrl[f],
                                   rtol=8e-3, atol=5e-4)
