"""The port's blend backward (K4's plain version) against the JAX
package's ``blend_backward`` (Pallas in interpret mode) on the same sorted
table, tile ranges, image cotangent and forward rgb; and against torch
autograd through the port's plain forward.

Gates: rows 0..8 atol 5e-4, rtol 1e-3 (the JAX package's gradient gate;
its kernel takes the transmittance as a log-space prefix, within 7e-5,
and sums the pixels by matmuls); rows 10, 11 (|grad_uv| sum, pixel count)
rtol 1e-3; the |grad_uv| image atol 1e-4. Dense frames whose pixels
saturate are held against autograd only: there JAX's approximate
transmittance moves a pixel across the 1e-4 stop now and then.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import blend_pallas as jb  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

GATE = dict(atol=5e-4, rtol=1e-3)


def _inputs(tile, n=200, seed=7, scale_shift=0.0):
    xyz, feats, invalid = make_scene(n, seed)
    feats[:, 4:7] += scale_shift
    cfg = tr.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    raw, radius = tr.compute_raw_attrs(
        *map(torch.from_numpy, (xyz, feats, Q_ID, T_ID)), cam)
    keys, table, _ = tr.build_keys(raw, radius, torch.from_numpy(invalid),
                                   cam, cfg)
    kw = dict(tile=tile, tiles_x=64 // tile[0], tiles_y=64 // tile[1])
    cfin = blend.blend_forward_plain(table, keys.tile_start, keys.tile_end,
                                     rgb_only=True, **kw)[..., 0:3]
    g = np.random.default_rng(0).normal(size=tuple(cfin.shape))
    return table, keys, kw, torch.from_numpy(g.astype(np.float32)), \
        cfin.contiguous()


def _jax_backward(table, keys, kw, g, cfin, **flags):
    total = table.shape[1]
    cap_pad = -(-total // jb.CHUNK) * jb.CHUNK
    padded = np.zeros((16, cap_pad), np.float32)
    padded[:, :total] = table.numpy()
    padded[10] = 0.0  # the port's table keeps the point index there
    d, img = jb.blend_backward(
        jnp.asarray(padded), jnp.asarray(keys.tile_start.numpy()),
        jnp.asarray(keys.tile_end.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(cfin.numpy()), interpret=True, **kw, **flags)
    return np.asarray(d)[:, :total], np.asarray(img)


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
def test_blend_backward_matches_jax(tile):
    table, keys, kw, g, cfin = _inputs(tile)
    want, img_w = _jax_backward(table, keys, kw, g, cfin)
    got, img = blend.blend_backward(table, keys.tile_start, keys.tile_end,
                                    g, cfin, **kw)
    got = got.numpy()
    np.testing.assert_allclose(got[0:9], want[0:9], **GATE)
    np.testing.assert_allclose(got[10:12], want[10:12], rtol=1e-3, atol=0)
    np.testing.assert_allclose(img.numpy(), img_w, rtol=0, atol=1e-4)
    assert not got[[9, 12, 13, 14, 15]].any()
    assert got[11].sum() > 0 and np.abs(got[2:5]).max() > 1e-2


def test_blend_backward_without_extra_info_matches_jax():
    table, keys, kw, g, cfin = _inputs((32, 32))
    want, img_w = _jax_backward(table, keys, kw, g, cfin, extra_info=False)
    got, img = blend.blend_backward(table, keys.tile_start, keys.tile_end,
                                    g, cfin, extra_info=False, **kw)
    np.testing.assert_allclose(got.numpy(), want, **GATE)
    assert not got[10:].any() and not img.numpy().any() and not img_w.any()


@pytest.mark.parametrize("scale_shift", [0.0, 1.0])
def test_blend_backward_matches_autograd_of_forward(scale_shift):
    """The closed form against torch autograd through the plain forward
    (straight-through clamp): rows 0..8 at the gradient gate."""
    table, keys, kw, g, cfin = _inputs((32, 32), n=600 if scale_shift else 200,
                                       scale_shift=scale_shift)
    cfin = blend.blend_forward_plain(table, keys.tile_start, keys.tile_end,
                                     **kw)[..., 0:3].contiguous()
    tab = table.clone().requires_grad_(True)
    out = blend.blend_forward_plain(tab, keys.tile_start, keys.tile_end, **kw)
    (want,) = torch.autograd.grad(torch.sum(out[..., 0:3] * g), tab)
    got, _ = blend.blend_backward(table, keys.tile_start, keys.tile_end, g,
                                  cfin, **kw)
    torch.testing.assert_close(got[0:9], want[0:9], **GATE)
    if scale_shift:  # dense: pixels saturate and stop early
        full = blend.blend_forward_plain(table, keys.tile_start,
                                         keys.tile_end, **kw)
        assert float(full[..., 6].min()) < 1e-3
