"""The port's band-parallel step and render (``parallel/tile_parallel.py``)
on two gloo ranks on the CPU, against the JAX package's
``make_tp_train_step`` on two devices of the CPU mesh (the band render:
its single-device ``rasterize``) and against the port's single-device
step and render, in the cases of tests/test_parallel.py:531 and :667.

Gates: losses at rtol 1e-4 against JAX (1e-6 against the port's own step);
gradients (Adam's first ``mu`` / (1 - b1)) at the gradient gate, atol
5e-4, rtol 1e-3; parameters within 2 lr of the other side, 1e-6 at the
median; the densify statistics against the port's single-device step as
JAX's test holds its own (pixels partition exactly across bands, so
counts and visibility are exact and sums agree to float round-off: rtol
2e-4), against JAX as tests/test_torch_rasterizer_stats.py (sums at rtol
8e-3, JAX truncates them to bf16); images at rgb/alpha 1e-4, depth 5e-4.
A band that no splat reaches runs with zero keys. The two ranks' states
are bit-identical.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.parallel import tile_parallel as jtp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr  # noqa: E402
from tests import torch_dist_workers as W  # noqa: E402
from tests.test_torch_data_parallel import (  # noqa: E402
    B1,
    GATE,
    _close_params,
    _jax_config,
    _jax_state,
)


def _jax_tp(name, mesh, steps):
    xyz, feats, img = W.tp_case(name)
    config = _jax_config(False)
    if "step" not in steps:
        steps["step"] = jtp.make_tp_train_step(config, W.TP_H, W.TP_W,
                                               mesh)[0]
    new, metrics, aux = steps["step"](
        _jax_state(config, xyz, feats, False), jnp.asarray(img),
        jnp.asarray(W.Q_ID), jnp.zeros(3), jnp.asarray(W.TP_K),
        jnp.asarray(3, jnp.int32))
    st = aux["stats"]
    return {"state": {"features": np.asarray(new.scene.features),
                      "xyz": np.asarray(new.scene.xyz),
                      "feat_mu": np.asarray(new.feat_opt[0].mu),
                      "pos_mu": np.asarray(new.pos_opt[0].mu),
                      "ctrl_grad_position": np.asarray(
                          new.ctrl.grad_position)},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "pred": np.asarray(aux["pred"]),
            "stats": {f: np.asarray(getattr(st, f)) for f in st._fields}}


def _single(name):
    xyz, feats, img = W.tp_case(name)
    config = W.port_config()
    step = ttr.make_train_step(config, W.TP_H, W.TP_W, device="cpu")
    new, metrics, aux = step(
        W.port_state(config, xyz, feats), torch.from_numpy(img),
        torch.from_numpy(W.Q_ID), torch.zeros(3), torch.from_numpy(W.TP_K),
        3)
    return W.state_np(new), metrics, aux


@pytest.fixture(scope="module")
def runs():
    port = W.spawn_ranks(W.tp_ranks)
    mesh = jtp.make_band_mesh(2)
    steps = {}
    return port, {name: _jax_tp(name, mesh, steps) for name in W.TP_CASES}


def test_ranks_hold_bit_identical_states(runs):
    port, _ = runs
    for name in W.TP_CASES:
        a, b = port[0][name]["state"], port[1][name]["state"]
        for k in a:
            assert np.array_equal(a[k], b[k]), (name, k)
        assert port[0][name]["metrics"] == port[1][name]["metrics"]
        np.testing.assert_array_equal(port[0][name]["pred"],
                                      port[1][name]["pred"])


@pytest.mark.parametrize("name", W.TP_CASES)
def test_tp_step_matches_single_device_step(runs, name):
    port, _ = runs
    got = port[0][name]
    single, m1, aux1 = _single(name)
    np.testing.assert_allclose(got["metrics"]["loss"], float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["metrics"]["psnr"], float(m1["psnr"]),
                               rtol=1e-6)
    for k in ("feat_mu", "pos_mu"):
        np.testing.assert_allclose(got["state"][k] / (1 - B1),
                                   single[k] / (1 - B1), **GATE)
    _close_params(got["state"], single)
    st1, st2 = aux1["stats"], got["stats"]
    np.testing.assert_array_equal(st2["in_camera"], st1.in_camera.numpy())
    np.testing.assert_array_equal(st2["num_affected_pixels"],
                                  st1.num_affected_pixels.numpy())
    np.testing.assert_array_equal(st2["num_overlap_tiles"],
                                  st1.num_overlap_tiles.numpy())
    for f in ("magnitude_grad_viewspace", "grad_uv"):
        np.testing.assert_allclose(st2[f], getattr(st1, f).numpy(),
                                   rtol=2e-4, atol=2e-9)
    np.testing.assert_allclose(got["state"]["ctrl_grad_position"],
                               single["ctrl_grad_position"], rtol=2e-4,
                               atol=1e-8)
    np.testing.assert_allclose(got["pred"], aux1["pred"].numpy(), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["point_uv"], aux1["point_uv"].numpy(),
                               atol=1e-4)
    assert got["metrics"]["num_keys"] == max(
        r[name]["band_keys"] for r in port)


@pytest.mark.parametrize("name", W.TP_CASES)
def test_tp_step_matches_jax(runs, name):
    port, jax_runs = runs
    got, want = port[0][name], jax_runs[name]
    for k in ("loss", "l1", "ssim", "psnr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-4)
    for k in ("feat_mu", "pos_mu"):
        assert np.abs(got["state"][k]).max() > 0, k
        np.testing.assert_allclose(got["state"][k] / (1 - B1),
                                   want["state"][k] / (1 - B1), **GATE)
    _close_params(got["state"], want["state"])
    np.testing.assert_array_equal(got["stats"]["in_camera"],
                                  want["stats"]["in_camera"])
    np.testing.assert_array_equal(got["stats"]["num_overlap_tiles"],
                                  want["stats"]["num_overlap_tiles"])
    for f in ("num_affected_pixels", "magnitude_grad_viewspace"):
        np.testing.assert_allclose(got["stats"][f], want["stats"][f],
                                   rtol=8e-3, atol=0)
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0, atol=1e-4)


def test_empty_band_has_no_keys(runs):
    port, _ = runs
    keys = [r["top_band"]["band_keys"] for r in port]
    assert keys[0] > 0 and keys[1] == 0, keys
    assert min(r["spanning"]["band_keys"] for r in port) > 0


def test_band_render_matches_single_device_render():
    got = W.spawn_ranks(W.band_render_ranks)
    for f in got[0]:
        np.testing.assert_array_equal(got[0][f], got[1][f])
    xyz, feats, K, w, h = W.band_render_scene()
    ref = tr.rasterize(torch.from_numpy(xyz), torch.from_numpy(feats),
                       torch.zeros(len(xyz), dtype=torch.bool),
                       torch.from_numpy(W.Q_ID), torch.zeros(3),
                       tr.Camera(torch.from_numpy(K), w, h),
                       tr.RasterizerConfig(tile_size=32))
    out = got[0]
    for f, atol in (("rgb", 1e-4), ("alpha", 1e-4), ("depth", 5e-4)):
        np.testing.assert_allclose(out[f], getattr(ref, f).numpy(), rtol=0,
                                   atol=atol)
    np.testing.assert_array_equal(out["count"], ref.count.numpy())
    # and the JAX package's single-device render (its band render on the
    # CPU mesh takes minutes in interpret mode; tests/test_parallel.py:667
    # holds it to this render)
    jout = jr.rasterize(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.zeros(len(xyz), bool),
        jnp.asarray(W.Q_ID), jnp.zeros(3),
        jr.Camera(K=jnp.asarray(K), width=w, height=h),
        jr.RasterizerConfig(tile_size=32, key_cap=2048, interpret=True))
    for f, atol in (("rgb", 1e-4), ("alpha", 1e-4), ("depth", 5e-4)):
        np.testing.assert_allclose(out[f], np.asarray(getattr(jout, f)),
                                   rtol=0, atol=atol)
    np.testing.assert_array_equal(out["count"], np.asarray(jout.count))
