"""The port's densify controller against the JAX package's, from one state
after three JAX train steps (carried across by
``convert.train_state_from_jax``) and that frame's statistics:

- ``find_densify``'s masks exactly, its split size reduction and averaged
  position gradients at 1e-6 relative;
- ``apply_densify_with_noise`` fed JAX's own normal draws (the two keys of
  ``jax.random.split(key)``, as ``controller.py`` draws them) against
  ``apply_densify``: positions and features within 1e-6, ``invalid`` and
  ``object_id`` exactly, with fewer and with more densify sources than
  free slots;
- ``reset_alpha`` exactly.
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
from taichi_3d_gaussian_splatting_tpu.training import controller as jc  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training import trainer as jtr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.training.config import (  # noqa: E402
    TrainConfig as JTrainConfig,
)
from taichi_3d_gaussian_splatting_tpu_torch.convert import (  # noqa: E402
    train_state_from_jax,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (  # noqa: E402
    GradStats,
)
from taichi_3d_gaussian_splatting_tpu_torch.training import controller as tc  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

PAD = 40  # free slots at the end of the pool
MASKS = ("remove_mask", "densify_mask", "over_mask")


@pytest.fixture(scope="module")
def frame():
    """(JAX state, its stats and depths, the port's state and stats) after
    three JAX train steps on a pool with free slots, a few transparent
    points and one NaN row."""
    xyz, feats, invalid = make_scene(160, seed=5)
    feats[20:26, 7] = -1.0            # transparent
    feats[30, 12] = np.nan            # NaN-poisoned
    xyz = np.concatenate([xyz, np.zeros((PAD, 3), np.float32)])
    feats = np.concatenate([feats, np.zeros((PAD, 56), np.float32)])
    invalid = np.concatenate([invalid, np.ones((PAD,), bool)])
    oid = np.arange(len(xyz), dtype=np.int32) % 3
    n = len(xyz)
    jconfig = JTrainConfig(rasterisation_config=JRasterizerConfig(
        tile_size=32, key_cap=4096, interpret=True))
    scene = GaussianScene(xyz=jnp.asarray(xyz), features=jnp.asarray(feats),
                          invalid=jnp.asarray(invalid),
                          object_id=jnp.asarray(oid))
    ftx, ptx = jtr.make_optimizers(jconfig)
    js = jtr.TrainState(scene=scene, feat_opt=ftx.init(scene.features),
                        pos_opt=ptx.init(scene.xyz), ctrl=jc.init_state(n))
    step = jtr.make_train_step(jconfig, 64, 64)
    gt = (np.random.default_rng(2).random((64, 64, 3)) * 255).astype(np.uint8)
    args = [jnp.asarray(a) for a in (gt, Q_ID, T_ID, make_K())]
    for _ in range(3):
        js, _, aux = step(js, *args, jnp.asarray(3, jnp.int32))
    # NaN features reach the NaN row's own updates only; keep it NaN so the
    # selection's NaN test has a row to find
    js = js._replace(scene=js.scene._replace(
        features=js.scene.features.at[30, 12].set(jnp.nan)))
    ts = train_state_from_jax(js.scene, js.feat_opt[0], js.pos_opt[0],
                              js.ctrl, device="cpu")
    st = aux["stats"]
    t_stats = GradStats(*[torch.from_numpy(np.array(getattr(st, f)))
                          for f in GradStats._fields])
    return (js, st, aux["point_depth"], ts, t_stats,
            torch.from_numpy(np.array(aux["point_depth"])))


def _config(ts, t_stats, **over):
    """Thresholds at the medians of this frame's statistics, so every mask
    has members on both sides."""
    c = ts.ctrl
    seen = c.num_in_camera > 0

    def med(x):
        return float(torch.median(x[seen & torch.isfinite(x)]))

    npix = t_stats.num_affected_pixels
    kw = dict(
        densification_view_space_position_gradients_threshold=med(
            t_stats.magnitude_grad_viewspace),
        densification_view_avg_space_position_gradients_threshold=med(
            t_stats.magnitude_grad_viewspace / npix) * 4,
        densification_multi_frame_view_space_position_gradients_threshold=med(
            c.grad_viewspace / c.num_in_camera) * 2,
        densification_multi_frame_view_pixel_avg_space_position_gradients_threshold=1e3,
        densification_multi_frame_position_gradients_threshold=med(
            c.grad_position_norm / c.num_in_camera) * 3,
        under_reconstructed_num_pixels_threshold=int(med(c.num_pixels)),
        floater_near_camrea_num_pixels_threshold=int(
            torch.quantile(npix[seen], 0.9)),
        floater_depth_threshold=6.0,
    )
    kw.update(over)
    return jc.ControllerConfig(**kw)


def _find(frame, cfg, remove_floaters):
    js, st, depth, ts, t_stats, t_depth = frame
    jinfo = jc.find_densify(js.scene, js.ctrl, st.in_camera,
                            st.num_affected_pixels,
                            st.magnitude_grad_viewspace, depth,
                            remove_floaters, cfg)
    tcfg = tc.ControllerConfig(**dataclasses.asdict(cfg))
    tinfo = tc.find_densify(ts.scene, ts.ctrl, t_stats.in_camera,
                            t_stats.num_affected_pixels,
                            t_stats.magnitude_grad_viewspace, t_depth,
                            remove_floaters, tcfg)
    return jinfo, tinfo, tcfg


@pytest.mark.parametrize("remove_floaters", [False, True])
def test_find_densify_matches_jax(frame, remove_floaters):
    cfg = _config(frame[3], frame[4])
    jinfo, tinfo, _ = _find(frame, cfg, remove_floaters)
    for name in MASKS:
        got, want = getattr(tinfo, name).numpy(), np.asarray(getattr(jinfo,
                                                                     name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert 0 < got.sum() < len(got), name
    if remove_floaters:  # the floaters join the transparent and NaN rows
        assert tinfo.remove_mask.sum() > 7
    assert bool(tinfo.remove_mask[30])  # the NaN row
    for name in ("size_reduction", "grad_position", "position_before"):
        np.testing.assert_allclose(getattr(tinfo, name).numpy(),
                                   np.asarray(getattr(jinfo, name)),
                                   rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("overfull", [False, True])
@pytest.mark.parametrize("sample, ellipsoid", [(True, False), (True, True),
                                               (False, False)])
def test_apply_densify_with_jax_noise(frame, overfull, sample, ellipsoid):
    js, ts = frame[0], frame[3]
    over = dict(enable_sample_from_point=sample,
                enable_ellipsoid_offset=ellipsoid)
    if overfull:  # every valid in-camera point densifies
        over["densification_view_space_position_gradients_threshold"] = -1.0
    cfg = _config(ts, frame[4], **over)
    jinfo, tinfo, tcfg = _find(frame, cfg, True)
    n_dens = int(tinfo.densify_mask.sum())
    n_free = int((ts.scene.invalid | tinfo.remove_mask).sum())
    assert (n_dens > n_free) == overfull and n_dens > 0

    key = jax.random.PRNGKey(7)
    want = jc.apply_densify(js.scene, jinfo, key, cfg)
    k1, k2 = jax.random.split(key)
    shape = js.scene.xyz.shape
    eps = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
           for k in (k1, k2)]
    got = tc.apply_densify_with_noise(ts.scene, tinfo, *eps, tcfg)

    for name in ("invalid", "object_id"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # NaN rows stay where they were, in both
    for name in ("xyz", "features"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    n_valid = int((~ts.scene.invalid).sum())
    n_removed = int(tinfo.remove_mask.sum())
    assert int(got.num_valid()) == n_valid - n_removed + min(n_dens, n_free)


def test_apply_densify_draws_from_the_generator(frame):
    ts = frame[3]
    cfg = _config(ts, frame[4])
    _, tinfo, tcfg = _find(frame, cfg, False)
    g = torch.Generator().manual_seed(3)
    got = tc.apply_densify(ts.scene, tinfo, g, tcfg)
    g2 = torch.Generator().manual_seed(3)
    eps = [torch.randn(tuple(ts.scene.xyz.shape), generator=g2)
           for _ in range(2)]
    want = tc.apply_densify_with_noise(ts.scene, tinfo, *eps, tcfg)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(g.get_state(), g2.get_state())
    assert int(got.num_valid()) > int(ts.scene.num_valid()) - int(
        tinfo.remove_mask.sum())


def test_reset_alpha_matches_jax(frame):
    js, ts = frame[0], frame[3]
    cfg = jc.ControllerConfig(reset_alpha_value=0.1)
    want = np.asarray(jc.reset_alpha(js.scene, cfg).features)
    got = tc.reset_alpha(ts.scene, tc.ControllerConfig(reset_alpha_value=0.1))
    np.testing.assert_array_equal(got.features.numpy(), want)
    assert float(got.features[:, 7].max()) == float(np.float32(0.1))
    assert not torch.equal(got.features, ts.scene.features)
