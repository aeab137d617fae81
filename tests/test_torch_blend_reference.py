"""The port's rasterizer and its dense oracle against the JAX package's
dense oracle ``render_reference``, at the JAX package's image gates: rgb
and alpha atol 1e-4, depth atol 5e-4, count exact; and the oracles'
gradients at its gradient gate, atol 5e-4 and rtol 1e-3."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import blend_reference as jref  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend_reference as tref  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import (  # noqa: E402
    JCFG, TCFG, _assert_images_close, _inputs,
)
from tests.torch_port_scenes import (  # noqa: E402
    Q_ID, T_ID, make_K, make_saturating_scene,
)


def test_rasterize_matches_jax_reference():
    j, jcam, t, tcam = _inputs(seed=21)
    want = jref.render_reference(*j, jcam, JCFG)
    got = tr.rasterize(*t, tcam, TCFG)
    _assert_images_close(got, want)
    assert float(got.count.max()) >= 3  # splats overlap


def test_reference_matches_jax_reference():
    j, jcam, t, tcam = _inputs(n=120, seed=5)
    cfg = dataclasses.replace(JCFG, tile_h=16)
    want = jref.render_reference(*j, jcam, cfg)
    got = tref.render_reference(*t, tcam, dataclasses.replace(TCFG, tile_h=16))
    _assert_images_close(got, want)


def _oracle_grads(xyz, feats, invalid, g):
    x = torch.from_numpy(xyz).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    rgb, _, alpha, _ = tref.render_reference(
        x, f, torch.from_numpy(invalid), torch.from_numpy(Q_ID),
        torch.from_numpy(T_ID), tr.Camera(torch.from_numpy(make_K()), 64, 64),
        TCFG)
    assert float(alpha.detach().max()) > 0.999  # saturated somewhere
    gx, gf = torch.autograd.grad(torch.sum(rgb * torch.from_numpy(g)), (x, f))
    return gx.numpy(), gf.numpy()


def test_reference_gradients_match_jax_when_alpha_saturates(monkeypatch):
    """Most (pixel, splat) pairs have alpha > 0.99, where the clamp is
    active: its straight-through gradient must match JAX's, and a clamp
    that passes no gradient there must not."""
    xyz, feats, invalid = make_saturating_scene()
    g = np.random.default_rng(0).normal(size=(64, 64, 3)).astype(np.float32)
    K = make_K()

    def loss_j(x, f):
        rgb, *_ = jref.render_reference(
            x, f, jnp.asarray(invalid), jnp.asarray(Q_ID), jnp.asarray(T_ID),
            jr.Camera(jnp.asarray(K), 64, 64), JCFG)
        return jnp.sum(rgb * jnp.asarray(g))

    gx_j, gf_j = (np.asarray(a) for a in jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(xyz), jnp.asarray(feats)))
    gx_t, gf_t = _oracle_grads(xyz, feats, invalid, g)
    np.testing.assert_allclose(gx_t, gx_j, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(gf_t, gf_j, atol=5e-4, rtol=1e-3)

    monkeypatch.setattr(tref, "straight_through_clamp",
                        lambda a: torch.clamp_max(a, tref.ALPHA_CLAMP))
    gx_h, _ = _oracle_grads(xyz, feats, invalid, g)
    assert not np.allclose(gx_h, gx_j, atol=5e-4, rtol=1e-3)
