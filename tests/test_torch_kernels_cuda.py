"""Card-only: each CUDA kernel of the render path against its plain PyTorch
version on the same inputs, at the small size of the CPU tests.

Needs an NVIDIA card and nvcc; skipped elsewhere. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: expand_keys and bucket_histogram are integer/copy kernels and
must match bit for bit; the blend kernel keeps a sequential transmittance
where the plain version takes a parallel cumprod, so rgb/alpha agree to
1e-4, depth to 5e-4 (the JAX package's own image gates) and, at this
size, the count exactly.
"""
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, expand, histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _frame(dev, tile=(32, 32), n=200, seed=7, scale_shift=0.0):
    xyz, feats, invalid = make_scene(n, seed)
    feats[:, 4:7] += scale_shift
    cfg = R.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    raw, radius = R.compute_raw_attrs(to(xyz), to(feats), to(Q_ID), to(T_ID),
                                      cam)
    return cfg, cam, raw, radius, to(invalid), (to(xyz), to(feats),
                                                to(invalid))


def _expand_inputs(cfg, cam, raw, radius, invalid):
    tile = R._cfg_tile(cfg)
    visible = R.frustum_cull_mask(raw.uv, raw.depth, invalid, cam.width,
                                  cam.height, cfg.near_plane, cfg.far_plane,
                                  tile)
    r = tiling.point_key_ranges(raw.uv, raw.depth, radius, visible, cam.width,
                                cam.height, tile, cfg.depth_to_sort_key_scale)
    tiles_u = cam.width // tile[0]
    num_tiles = tiles_u * (cam.height // tile[1])
    dbits = tiling._depth_bits(num_tiles)
    att = R.attr_columns(raw)
    att = torch.where(torch.isfinite(att), att, torch.zeros_like(att))
    kw = dict(total=r.total, tiles_u=tiles_u, tile_w=tile[0], tile_h=tile[1],
              dbits=dbits, sentinel=((num_tiles + 1) << dbits) - 1)
    return (r.offsets, r.counts, r.dkey, r.base, r.h, att.contiguous()), kw


def test_histogram_matches_plain(dev):
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(-5, 530, 50_000).astype(np.int32))
    ids = ids.to(dev)
    for nb in (1, 4, 510, 20_000):
        before = histogram.bucket_histogram.launches
        got = histogram.bucket_histogram(ids, nb)
        assert histogram.bucket_histogram.launches == before + 1
        want = histogram.bucket_histogram_plain(ids, nb)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("exact_cull", [False, True])
def test_expand_matches_plain(dev, exact_cull):
    cfg, cam, raw, radius, invalid, _ = _frame(dev)
    args, kw = _expand_inputs(cfg, cam, raw, radius, invalid)
    assert kw["total"] > 0
    before = expand.expand_keys.launches
    fused, table = expand.expand_keys(*args, **kw, exact_cull=exact_cull)
    assert expand.expand_keys.launches == before + 1
    fused_p, table_p = expand.expand_keys_plain(*args, **kw,
                                                exact_cull=exact_cull)
    torch.testing.assert_close(fused, fused_p, rtol=0, atol=0)
    torch.testing.assert_close(table, table_p, rtol=0, atol=0)


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
@pytest.mark.parametrize("rgb_only", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_blend_matches_plain(dev, tile, rgb_only, dense):
    # dense: larger, overlapping splats, so pixels saturate and stop early
    cfg, cam, raw, radius, invalid, _ = _frame(
        dev, tile, n=2000 if dense else 200, scale_shift=1.0 if dense else 0.0)
    keys, table, _ = R.build_keys(raw, radius, invalid, cam, cfg)
    kw = dict(tile=tile, tiles_x=cam.width // tile[0],
              tiles_y=cam.height // tile[1], rgb_only=rgb_only)
    before = blend.blend_forward.launches
    got = blend.blend_forward(table, keys.tile_start, keys.tile_end, **kw)
    assert blend.blend_forward.launches == before + 1
    want = blend.blend_forward_plain(table, keys.tile_start, keys.tile_end,
                                     **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[..., 0:3], want[..., 0:3], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got[..., 6], want[..., 6], rtol=0, atol=1e-4)
    if not rgb_only:
        d_got = got[..., 3] / torch.clamp_min(got[..., 4], 1e-6)
        d_want = want[..., 3] / torch.clamp_min(want[..., 4], 1e-6)
        torch.testing.assert_close(d_got, d_want, rtol=0, atol=5e-4)
        torch.testing.assert_close(got[..., 5], want[..., 5], rtol=0, atol=0)
    if dense and not rgb_only:
        assert float(want[..., 6].min()) < 1e-3, "scene never saturates"


def test_rasterize_launches_every_kernel(dev):
    cfg, cam, _, _, _, (xyz, feats, invalid) = _frame(dev)
    counters = (expand.expand_keys, histogram.bucket_histogram,
                blend.blend_forward)
    before = [f.launches for f in counters]
    out = R.rasterize(xyz, feats, invalid, torch.from_numpy(Q_ID).to(dev),
                      torch.from_numpy(T_ID).to(dev), cam, cfg)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert out.rgb.shape == (64, 64, 3) and out.rgb.is_cuda
    assert bool(torch.isfinite(out.rgb).all()) and float(out.rgb.max()) > 0
