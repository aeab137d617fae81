"""The blend's counts against a float64 reference, on the CPU.

``f64_counts`` blends every tile's sorted keys front to back in float64,
one key at a time, with the kernels' f32 thresholds (skip alpha < 1/255,
clamp at 0.99, stop where T (1 - alpha) < 1e-4; the stopping key is not
blended): each pixel's count of blended keys and each key's count of
pixels that blend it. ``blend_forward_plain``'s per-pixel count (output
field 5) and ``blend_backward_plain``'s per-key count (d_table row 11) must
equal it exactly on the 64x64 scenes of the card tests'
``test_blend_matches_plain`` and ``test_blend_backward_matches_plain``:
a count may differ from the float64 one only through f32 rounding at a
threshold, which these scenes do not reach.
"""
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import blend
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops.tiling import tile_wh
from tests.torch_port_scenes import small_frame

ALPHA_SKIP = float(np.float32(1.0) / np.float32(255.0))
ALPHA_CLAMP = float(np.float32(0.99))
T_SATURATION = float(np.float32(1e-4))


def f64_counts(table, tile_start, tile_end, tile):
    """(count of keys each pixel blends (tiles, px), count of pixels that
    blend each key (cap,)) of a float64 sequential blend of the sorted
    ``table``'s rows u, v, conic a, b, c, logro over each tile's range."""
    tw, th = tile_wh(tile)
    i = torch.arange(tw * th)
    x = ((i % tw).double() + 0.5)[None, :]
    y = (torch.div(i, tw, rounding_mode="floor").double() + 0.5)[None, :]
    start = tile_start.long()
    n = torch.clamp_min(tile_end.long() - start, 0)
    cap = table.shape[1]
    tab = table[0:6].double()
    shape = (start.shape[0], tw * th)
    T = torch.ones(shape, dtype=torch.float64)
    live = torch.ones(shape, dtype=torch.bool)
    count = torch.zeros(shape, dtype=torch.int64)
    per_key = torch.zeros(cap + 1, dtype=torch.int64)
    for j in range(int(n.max()) if len(n) else 0):
        if j % 64 == 0 and not bool((live & (n[:, None] > j)).any()):
            break  # every pixel has stopped or run out of keys
        has = n > j
        col = torch.where(has, start + j, cap)
        u, v, ca, cb, cc, lr = tab[:, torch.clamp_max(col, cap - 1)][:, :,
                                                                      None]
        dx, dy = x - u, y - v
        alpha = torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy)
                          - cb * dx * dy + lr)
        hit = live & has[:, None] & (alpha >= ALPHA_SKIP)
        nxt = T * (1.0 - torch.clamp_max(alpha, ALPHA_CLAMP))
        stop = hit & (nxt < T_SATURATION)
        inc = hit & ~stop
        live &= ~stop
        T = torch.where(inc, nxt, T)
        count += inc
        per_key[col] = inc.sum(1)
    return count, per_key[:cap]


def _keys(tile, dense):
    cfg, cam, raw, radius, invalid, _ = small_frame(
        "cpu", tile, n=2000 if dense else 200,
        scale_shift=1.0 if dense else 0.0)
    keys, table, _ = R.build_keys(raw, radius, invalid, cam, cfg)
    kw = dict(tile=tile, tiles_x=cam.width // tile[0],
              tiles_y=cam.height // tile[1])
    return keys, table, kw


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (32, 8), (16, 16),
                                  (48, 2), (12, 4)])
@pytest.mark.parametrize("dense", [False, True])
def test_forward_count_is_the_float64_blends(tile, dense):
    keys, table, kw = _keys(tile, dense)
    out = blend.blend_forward_plain(table, keys.tile_start, keys.tile_end,
                                    **kw)
    want, _ = f64_counts(table, keys.tile_start, keys.tile_end, tile)
    got = out[..., 5].long()
    assert torch.equal(got, want), torch.nonzero(got != want)[:10].tolist()
    assert int(want.sum()) > 0


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (32, 8), (16, 16),
                                  (48, 2)])
@pytest.mark.parametrize("dense", [False, True])
def test_backward_count_is_the_float64_blends(tile, dense):
    keys, table, kw = _keys(tile, dense)
    cfin = blend.blend_forward_plain(table, keys.tile_start, keys.tile_end,
                                     rgb_only=True, **kw)[..., 0:3]
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(cfin.shape)).astype(np.float32))
    d_table, _ = blend.blend_backward_plain(
        table, keys.tile_start, keys.tile_end, g, cfin.contiguous(), **kw)
    _, want = f64_counts(table, keys.tile_start, keys.tile_end, tile)
    got = d_table[11].long()
    assert torch.equal(got, want), torch.nonzero(got != want)[:10].tolist()
    assert int(want.sum()) > 0
