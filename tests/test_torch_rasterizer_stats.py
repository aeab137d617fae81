"""The port's densification statistics (``GradStats`` of
``rasterize_bwd``) against the JAX package's.

Gates: the gradients and ``grad_uv`` at the gradient gate (atol 5e-4,
rtol 1e-3); ``magnitude_grad_viewspace`` and ``num_affected_pixels`` at
rtol 8e-3, since JAX truncates the per-key rows to bf16 (8 mantissa bits,
toward zero) for its regroup sort; ``num_overlap_tiles`` and
``in_camera`` exactly; the |grad_uv| image (not slim) at atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import JCFG, TCFG  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_odd_scene  # noqa: E402

GATE = dict(atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("slim", [False, True])
def test_grad_stats_match_jax(slim):
    xyz, feats, invalid = make_odd_scene(160, seed=3)
    g = np.random.default_rng(1).normal(size=(64, 64, 3)).astype(np.float32)
    jcfg = dataclasses.replace(JCFG, slim=slim)
    tcfg = dataclasses.replace(TCFG, slim=slim)
    jcam = jr.Camera(jnp.asarray(make_K()), 64, 64)
    _, jctx, jvjp = jr.rasterize_fwd_ctx(
        *map(jnp.asarray, (xyz, feats, invalid, Q_ID, T_ID)), jcam, jcfg)
    (wx, wf), want = jr.rasterize_bwd(jctx, jvjp, jnp.asarray(g), jcam, jcfg)
    tcam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    _, ctx, vjp = tr.rasterize_fwd_ctx(
        *map(torch.from_numpy, (xyz, feats, invalid, Q_ID, T_ID)), tcam, tcfg)
    (gx, gf), got = tr.rasterize_bwd(ctx, vjp, torch.from_numpy(g), tcam,
                                     tcfg)
    assert got._fields == want._fields
    # JAX's VJP is NaN on the zero-padded rows (zero quaternion) and at the
    # camera centre (zero view direction), where the port's is finite
    wx, wf = np.asarray(wx), np.asarray(wf)
    ok = np.isfinite(wx).all(1) & np.isfinite(wf).all(1)
    n = len(xyz)
    assert set(np.flatnonzero(~ok)) == {n // 10, n - 4, n - 3, n - 2, n - 1}
    assert np.isfinite(gx.numpy()).all() and np.isfinite(gf.numpy()).all()
    np.testing.assert_allclose(gx.numpy()[ok], wx[ok], **GATE)
    np.testing.assert_allclose(gf.numpy()[ok], wf[ok], **GATE)
    np.testing.assert_allclose(got.grad_uv.numpy(), np.asarray(want.grad_uv),
                               **GATE)
    for f in ("magnitude_grad_viewspace", "num_affected_pixels"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=8e-3,
                                   atol=1e-12)
    np.testing.assert_array_equal(got.num_overlap_tiles.numpy(),
                                  np.asarray(want.num_overlap_tiles))
    np.testing.assert_array_equal(got.in_camera.numpy(),
                                  np.asarray(want.in_camera))
    img = got.magnitude_grad_viewspace_on_image.numpy()
    assert img.shape == np.asarray(
        want.magnitude_grad_viewspace_on_image).shape
    if slim:
        assert img.shape == (1, 1, 2) and not img.any()
    else:
        np.testing.assert_allclose(
            img, np.asarray(want.magnitude_grad_viewspace_on_image), rtol=0,
            atol=1e-4)
        assert img.max() > 0
    assert got.num_affected_pixels.numpy().max() > 0
