"""The port's forward rasterizer (plain kernel versions, on the CPU)
against the JAX package's ``rasterize`` (Pallas in interpret mode).

Gates are the JAX package's own between its Pallas path and its oracle
(tests/test_rasterizer.py): rgb and alpha atol 1e-4, depth atol 5e-4,
count exact. JAX's blend keeps a log-space transmittance prefix that is
within 7e-5 of exact; the port's is exact.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

JCFG = jr.RasterizerConfig(tile_size=32, key_cap=4096, interpret=True)
TCFG = tr.RasterizerConfig(tile_size=32)


def _inputs(n=200, seed=13):
    xyz, feats, invalid = make_scene(n, seed)
    j = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(invalid),
         jnp.asarray(Q_ID), jnp.asarray(T_ID))
    t = tuple(torch.from_numpy(a) for a in (xyz, feats, invalid, Q_ID, T_ID))
    return (j, jr.Camera(jnp.asarray(make_K()), 64, 64),
            t, tr.Camera(torch.from_numpy(make_K()), 64, 64))


def _assert_images_close(got, want, full=True):
    """got: the port's (rgb, depth, alpha, count); want: JAX's."""
    rgb, depth, alpha, count = (np.asarray(x) for x in want)
    np.testing.assert_allclose(got[0].numpy(), rgb, rtol=0, atol=1e-4)
    if not full:
        return
    np.testing.assert_allclose(got[2].numpy(), alpha, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), depth, rtol=0, atol=5e-4)
    np.testing.assert_array_equal(got[3].numpy().astype(np.int32),
                                  count.astype(np.int32))


@pytest.mark.parametrize("tile, rgb_only", [
    ((32, 32), False), ((32, 32), True), ((32, 16), False)])
def test_rasterize_matches_jax(tile, rgb_only):
    j, jcam, t, tcam = _inputs()
    jcfg = dataclasses.replace(JCFG, tile_size=tile[0], tile_h=tile[1],
                               rgb_only=rgb_only)
    tcfg = dataclasses.replace(TCFG, tile_size=tile[0], tile_h=tile[1],
                               rgb_only=rgb_only)
    want = jr.rasterize(*j, jcam, jcfg)
    got, total = tr.rasterize(*t, tcam, tcfg, return_num_keys=True)
    assert got.rgb.shape == (64, 64, 3) and total > 0
    assert float(got.rgb.max()) > 0.1
    _assert_images_close(got, want, full=not rgb_only)
    if rgb_only:
        assert float(got.depth.abs().max()) == 0.0


def test_rasterize_empty_view():
    """Every point behind the camera: no keys, a black image."""
    _, _, t, tcam = _inputs()
    xyz = t[0].clone()
    xyz[:, 2] = -xyz[:, 2]
    out, total = tr.rasterize(xyz, *t[1:], tcam, TCFG, return_num_keys=True)
    assert total == 0
    assert float(out.rgb.abs().max()) == 0.0 and float(out.alpha.max()) == 0.0
