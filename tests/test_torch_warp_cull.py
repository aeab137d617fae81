"""The blend kernels' per-warp key cull (``ops/blend.py::warp_key_cull_plain``,
``csrc/conic_cull.cuh``) is conservative.

A warp of 32 pixels walks only the keys whose quadratic's minimum over the
warp's pixel-centre rectangle may reach alpha >= 1/255. These tests hold
that, on the port's seeded scenes, no culled (warp, key) pair has a pixel
whose f32 alpha, taken as the blend takes it, reaches 1/255; that a NaN or
non-positive-definite conic is never culled; and that the cull does drop
pairs, so the kernels have work to save. CPU only: the test scenes' keys
come from the port's own ``build_keys``.
"""
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import blend
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from tests.torch_port_scenes import (
    Q_ID,
    T_ID,
    make_K,
    make_saturating_scene,
    make_scene,
)

# the kernels' 8x4 warp blocks, and two shapes that fall back to
# row-major warps: (48, 2) with warps across rows, (12, 4) with a partial
# last warp
TILES = [(32, 32), (32, 16), (32, 8), (16, 16), (48, 2), (12, 4)]


def _scene(name):
    if name == "sparse":
        return make_scene(200, 7)
    if name == "dense":  # larger, overlapping splats (the card tests' dense)
        xyz, feats, invalid = make_scene(2000, 7)
        feats[:, 4:7] += 1.0
        return xyz, feats, invalid
    return make_saturating_scene()


def _tiles(name, tile):
    """[(table columns of one tile's keys, tile)] of the scene at 64x64."""
    xyz, feats, invalid = (torch.from_numpy(a) for a in _scene(name))
    cfg = R.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    cam = R.Camera(torch.from_numpy(make_K()), 64, 64)
    raw, radius = R.compute_raw_attrs(xyz, feats, torch.from_numpy(Q_ID),
                                      torch.from_numpy(T_ID), cam)
    keys, table, _ = R.build_keys(raw, radius, invalid, cam, cfg)
    return [table[:, s:e] for s, e in zip(keys.tile_start.tolist(),
                                          keys.tile_end.tolist()) if e > s]


def _alpha(tab, tile):
    """(pixels, keys) alpha in the blend kernels' f32 operations."""
    x, y = blend._pixel_centres(tile[0], tile[1], tab.device)
    dx = x - tab[0]
    dy = y - tab[1]
    power = (-0.5 * (tab[2] * dx * dx + tab[4] * dy * dy)
             - tab[3] * dx * dy + tab[5])
    return torch.exp(power)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("scene", ["sparse", "dense", "saturating"])
def test_warp_cull_never_drops_a_reachable_pair(scene, tile):
    pairs = culled = 0
    for tab in _tiles(scene, tile):
        keep = blend.warp_key_cull_plain(tab, tile=tile)
        reach = _alpha(tab, tile) >= blend.ALPHA_SKIP_EPS  # (pixels, keys)
        pixel = blend.warp_layout(*tile)[0]  # thread -> pixel
        warp_reach = torch.stack([reach[pixel[32 * w:32 * w + 32]].any(0)
                                  for w in range(keep.shape[0])])
        bad = warp_reach & ~keep
        assert not bool(bad.any()), (
            f"{int(bad.sum())} culled (warp, key) pairs reach 1/255")
        pairs += keep.numel()
        culled += int((~keep).sum())
    assert pairs > 0
    if scene != "saturating":  # whose splats cover every pixel
        assert culled > 0


def test_warp_cull_drops_most_pairs_of_the_dense_scene():
    tile = (32, 32)
    kept = total = 0
    for tab in _tiles("dense", tile):
        keep = blend.warp_key_cull_plain(tab, tile=tile)
        kept += int(keep.sum())
        total += keep.numel()
    assert total > 10_000
    assert kept < 0.75 * total, (kept, total)


@pytest.mark.parametrize("tile", TILES)
def test_blending_only_kept_keys_gives_the_same_pixels(tile):
    """Each warp's pixels, blended from only the keys the warp keeps, equal
    the plain forward's over all the tile's keys: the count exactly, the
    rest to 1e-6 (the plain version's matmul and product reduce over
    fewer factors of 0 and 1, in another order)."""
    one = torch.zeros((1,), dtype=torch.int32)
    kw = dict(tile=tile, tiles_x=1, tiles_y=1)
    for tab in _tiles("dense", tile)[:6]:
        n = tab.shape[1]
        full = blend.blend_forward_plain(
            tab.contiguous(), one, one + n, **kw)[0]
        keep = blend.warp_key_cull_plain(tab, tile=tile)
        pixel = blend.warp_layout(*tile)[0]
        for w in range(keep.shape[0]):
            mine = pixel[32 * w:32 * w + 32]
            sub = tab[:, keep[w]].contiguous()
            got = blend.blend_forward_plain(
                sub, one, one + sub.shape[1], **kw)[0, mine]
            want = full[mine]
            assert torch.equal(got[:, 5], want[:, 5])
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", TILES + [(20, 20), (64, 16)])
def test_warp_layout_is_a_permutation_inside_its_rectangles(tile):
    """Every pixel has one thread, and each warp's rectangle holds the
    centres of its pixels; where the shape allows, a warp is an 8x4
    block."""
    tile_w, tile_h = tile
    pixel, x0, x1, y0, y1 = blend.warp_layout(tile_w, tile_h)
    npx = tile_w * tile_h
    assert torch.equal(torch.sort(pixel).values, torch.arange(npx))
    x = (pixel % tile_w).float() + 0.5
    y = torch.div(pixel, tile_w, rounding_mode="floor").float() + 0.5
    w = torch.div(torch.arange(npx), 32, rounding_mode="floor")
    assert bool(((x0[w, 0] <= x) & (x <= x1[w, 0])).all())
    assert bool(((y0[w, 0] <= y) & (y <= y1[w, 0])).all())
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        assert bool(((x1 - x0 == 7) & (y1 - y0 == 3)).all())


def _far_table(conics):
    """Table columns of keys centred 500 px from every warp, one per
    (a, b, c, logro) row of ``conics``."""
    n = len(conics)
    tab = torch.zeros((16, n), dtype=torch.float32)
    tab[0] = 500.0
    tab[1] = 500.0
    tab[2:6] = torch.tensor(conics, dtype=torch.float32).T
    return tab


def test_warp_cull_keeps_nan_and_degenerate_conics():
    nan = float("nan")
    bad = [
        [nan, 0.0, 1.0, 0.0],     # NaN conic a
        [1.0, nan, 1.0, 0.0],     # NaN conic b
        [1.0, 0.0, 1.0, nan],     # NaN log opacity
        [-1.0, 0.0, 1.0, 0.0],    # a < 0
        [1.0, 0.0, -1.0, 0.0],    # c < 0
        [0.0, 0.0, 1.0, 0.0],     # a = 0
        [1.0, 1.0, 1.0, 0.0],     # a c = b^2: singular
        [1.0, 2.0, 1.0, 0.0],     # indefinite
        [float("inf"), 0.0, 1.0, 0.0],
    ]
    for tile in TILES:
        keep = blend.warp_key_cull_plain(_far_table(bad), tile=tile)
        assert bool(keep.all()), keep
    tab = _far_table(bad)
    tab[0, 0] = nan  # a NaN centre with a NaN conic
    assert bool(blend.warp_key_cull_plain(tab, tile=(32, 32)).all())
    # the control: the same far key with a positive-definite conic is
    # culled by every warp
    good = blend.warp_key_cull_plain(_far_table([[1.0, 0.0, 1.0, 0.0]]),
                                     tile=(32, 32))
    assert not bool(good.any())


def test_warp_cull_keeps_a_key_reaching_one_corner_pixel():
    """A round splat whose 1/255 contour just covers pixel 31 (x 31.5,
    y 0.5), from outside the tile, is kept by that pixel's warp."""
    rng = np.random.default_rng(0)
    tile = (32, 32)
    warp = int((blend.warp_layout(*tile)[0] == 31).nonzero()[0, 0]) // 32
    for _ in range(50):
        s = float(rng.uniform(0.3, 2.0))
        a = 1.0 / s ** 2
        logro = 0.0
        # centre right of the pixel, at the distance where alpha = 1/255
        reach = float(np.sqrt(2 * (logro + np.log(255.0)) / a))
        u = 31.5 + reach * 0.999
        tab = _far_table([[a, 0.0, a, logro]])
        tab[0] = u
        tab[1] = 0.5
        keep = blend.warp_key_cull_plain(tab, tile=tile)
        alpha = _alpha(tab, tile)
        assert float(alpha[31, 0]) >= blend.ALPHA_SKIP_EPS
        assert bool(keep[warp, 0])
