"""The port's rasterizer gradients against the JAX package's: torch
autograd through ``rasterize`` against ``jax.grad`` (Pallas in interpret
mode), at the JAX package's gradient gate (atol 5e-4, rtol 1e-3); and the
port's explicit ``rasterize_fwd_ctx`` / ``rasterize_bwd`` pair against its
own autograd."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import JCFG, TCFG  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

GATE = dict(atol=5e-4, rtol=1e-3)


def _cotangent():
    return np.random.default_rng(0).normal(size=(64, 64, 3)).astype(
        np.float32)


def _torch_grads(xyz, feats, invalid, g, cfg):
    x = torch.from_numpy(xyz).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    out = tr.rasterize(x, f, torch.from_numpy(invalid),
                       torch.from_numpy(Q_ID), torch.from_numpy(T_ID),
                       tr.Camera(torch.from_numpy(make_K()), 64, 64), cfg)
    return torch.autograd.grad(torch.sum(out.rgb * torch.from_numpy(g)),
                               (x, f))


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
def test_rasterize_gradients_match_jax(tile):
    xyz, feats, invalid = make_scene(120, seed=5)
    g = _cotangent()
    jcfg = dataclasses.replace(JCFG, tile_size=tile[0], tile_h=tile[1])
    tcfg = dataclasses.replace(TCFG, tile_size=tile[0], tile_h=tile[1])
    cam = jr.Camera(jnp.asarray(make_K()), 64, 64)

    def loss(x, f):
        out = jr.rasterize(x, f, jnp.asarray(invalid), jnp.asarray(Q_ID),
                           jnp.asarray(T_ID), cam, jcfg)
        return jnp.sum(out.rgb * jnp.asarray(g))

    gx_j, gf_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xyz),
                                                jnp.asarray(feats))
    gx, gf = _torch_grads(xyz, feats, invalid, g, tcfg)
    assert torch.isfinite(gx).all() and torch.isfinite(gf).all()
    assert float(gf[:, 8].abs().max()) > 1e-2  # the DC colour gets gradient
    np.testing.assert_allclose(gx.numpy(), np.asarray(gx_j), **GATE)
    np.testing.assert_allclose(gf.numpy(), np.asarray(gf_j), **GATE)


@pytest.mark.parametrize("slim", [False, True])
def test_explicit_backward_matches_autograd(slim):
    xyz, feats, invalid = make_scene(100, seed=9)
    g = _cotangent()
    cfg = dataclasses.replace(TCFG, slim=slim)
    gx, gf = _torch_grads(xyz, feats, invalid, g, cfg)
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    out, ctx, vjp = tr.rasterize_fwd_ctx(
        *map(torch.from_numpy, (xyz, feats, invalid, Q_ID, T_ID)), cam, cfg)
    assert not out.rgb.requires_grad
    (gx2, gf2), stats = tr.rasterize_bwd(ctx, vjp, torch.from_numpy(g), cam,
                                         cfg)
    torch.testing.assert_close(gx2, gx, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(gf2, gf, atol=1e-6, rtol=1e-6)
    assert float(stats.num_affected_pixels.max()) > 0


def test_render_path_builds_no_graph():
    xyz, feats, invalid = make_scene(50, seed=2)
    out = tr.rasterize(*map(torch.from_numpy, (xyz, feats, invalid, Q_ID,
                                               T_ID)),
                       tr.Camera(torch.from_numpy(make_K()), 64, 64), TCFG)
    assert not out.rgb.requires_grad and out.rgb.grad_fn is None
