"""Card-only: each CUDA kernel of the port against its plain PyTorch version
on the same inputs, at the small size of the CPU tests and at the Truck
cell's full-width frame (428,687 points at 960x544, 32x32 tiles), and one
render and one train step launching every kernel of its path.

Needs an NVIDIA card and nvcc; skipped elsewhere. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances: the key expansion (slot_keys, sorted_table), tile_ranges,
tile_counts, the point-attributes kernel at the full-width frame and
segment_reduce must match bit for bit (integer and copy kernels, the
attribute kernel's rounding kept, and segment sums added in slot order
like their plain versions); the sorted table also equals the pre-sort
table gathered by the sort's permutation, and the segment sum through the
inverse permutation equals the unsorted kernel on the regrouped rows; the
blend kernel keeps a sequential transmittance
where the plain version takes a parallel cumprod, so rgb/alpha agree to
1e-4, depth to 5e-4 (the JAX package's own image gates) and the count
exactly at 64x64 and on all but 0.01% of the full-width pixels (f32
rounding at a threshold). blend_backward sums each key's pixel terms in
another order than the plain version's torch.sum: rows 0..8 and 10 agree
to 5e-4 + 1e-3 |plain| (the JAX package's gradient gate), the count and
the |grad_uv| image (1e-4) as the forward's. The point-attributes kernel
keeps the plain version's operation order and rounding, so its fields
agree to rtol 2e-6 / atol 1e-6 (a few ulps) with the same non-finite
pattern, and the cull mask and key total it gives exactly. The
attribute-VJP kernel adds its chain-rule terms in autograd's order, so its
gradients agree with autograd of the plain version to the JAX parity
test's rtol 1e-4 / atol 1e-5 (``test_torch_attributes_vjp.py``), and two
launches give the same bits.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as attrs
from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, expand, histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling
from taichi_3d_gaussian_splatting_tpu_torch.training import (
    checkpoint,
    controller,
    trainer,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from tests.torch_port_scenes import (
    Q_ID,
    T_ID,
    host_scalar_adam,
    make_K,
    make_odd_scene,
    make_scene,
    make_truck_scene,
    small_frame,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _expand_inputs(cfg, cam, raw, radius, invalid, nonfinite=False):
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
    if nonfinite:  # the kernels and their plain versions read them as 0
        att[2, ::7] = float("nan")
        att[6, 1::5] = float("inf")
        att[9, 3::11] = -float("inf")
    kw = dict(total=r.total, tiles_u=tiles_u, tile_w=tile[0], tile_h=tile[1],
              dbits=dbits, sentinel=((num_tiles + 1) << dbits) - 1)
    return (r.offsets, r.counts, r.dkey, r.base, r.h, att.contiguous()), kw


@pytest.mark.parametrize("case, num_tiles", [
    ("empty", 510), ("all_sentinel", 510), ("one_tile", 4),
    ("one_tile", 510), ("random", 4), ("random", 510), ("random", 20_000),
    ("frame", 4)])
def test_tile_ranges_matches_plain(dev, case, num_tiles):
    """K2 on the main path: equal to its plain version, to
    torch.searchsorted and to the exclusive cumsum of bucket_histogram."""
    dbits = tiling._depth_bits(num_tiles)
    sentinel = ((num_tiles + 1) << dbits) - 1
    rng = np.random.default_rng(num_tiles)
    if case == "frame":
        cfg, cam, raw, radius, invalid, _ = small_frame(
            dev, n=2000, scale_shift=1.0)
        keys, _, _ = R.build_keys(raw, radius, invalid, cam, cfg)
        fused = keys.fused  # a 64x64 frame of 32x32 tiles: num_tiles 4
    else:
        n = {"empty": 0, "all_sentinel": 300, "one_tile": 700,
             "random": 100_000}[case]
        tids = {"all_sentinel": np.full(n, num_tiles),
                "one_tile": np.full(n, num_tiles // 2)}.get(
                    case, rng.integers(0, num_tiles + 1, n))
        keys_np = (tids.astype(np.int64) << dbits) | rng.integers(
            0, 1 << dbits, n)
        keys_np = np.minimum(keys_np, sentinel)
        fused = torch.from_numpy(np.sort(keys_np).astype(np.int32)).to(dev)
    before = histogram.tile_ranges.launches
    got = histogram.tile_ranges(fused, dbits, num_tiles)
    assert histogram.tile_ranges.launches == before + 1
    want = histogram.tile_ranges_plain(fused, dbits, num_tiles)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    tid = (fused >> dbits).contiguous()
    torch.testing.assert_close(
        got.long(), torch.searchsorted(tid, torch.arange(
            num_tiles + 1, dtype=torch.int32, device=dev)), rtol=0, atol=0)
    hist = histogram.bucket_histogram(tid, num_tiles)
    torch.testing.assert_close(got[1:], torch.cumsum(hist, 0).int(), rtol=0,
                               atol=0)
    assert int(got[0]) == 0


@pytest.mark.parametrize("exact_cull", [False, True])
def test_expand_matches_plain(dev, exact_cull):
    cfg, cam, raw, radius, invalid, _ = small_frame(dev)
    args, kw = _expand_inputs(cfg, cam, raw, radius, invalid)
    assert kw["total"] > 0
    before = (expand.slot_keys.launches, expand.sorted_table.launches)
    fused, owner = expand.slot_keys(*args, **kw, exact_cull=exact_cull)
    fused_p, owner_p = expand.slot_keys_plain(*args, **kw,
                                              exact_cull=exact_cull)
    torch.testing.assert_close(fused, fused_p, rtol=0, atol=0)
    torch.testing.assert_close(owner, owner_p, rtol=0, atol=0)
    fused, table = expand.expand_keys(*args, **kw, exact_cull=exact_cull)
    assert (expand.slot_keys.launches, expand.sorted_table.launches) == (
        before[0] + 2, before[1] + 1)
    fused_p, table_p = expand.expand_keys_plain(*args, **kw,
                                                exact_cull=exact_cull)
    torch.testing.assert_close(fused, fused_p, rtol=0, atol=0)
    torch.testing.assert_close(table, table_p, rtol=0, atol=0)


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
@pytest.mark.parametrize("exact_cull", [False, True])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_sorted_table_matches_plain(dev, tile, exact_cull, nonfinite):
    """K1b after the sort: equal to its plain version and to the pre-sort
    table gathered by the sort's permutation."""
    cfg, cam, raw, radius, invalid, _ = small_frame(
        dev, tile, n=2000, scale_shift=1.0)
    args, kw = _expand_inputs(cfg, cam, raw, radius, invalid, nonfinite)
    fused, owner = expand.slot_keys(*args, **kw, exact_cull=exact_cull)
    fused_s, perm = torch.sort(fused, stable=True)
    tkw = {k: kw[k] for k in ("tiles_u", "tile_w", "tile_h", "dbits",
                              "sentinel")}
    before = expand.sorted_table.launches
    table = expand.sorted_table(fused_s, perm, owner, args[5], **tkw)
    assert expand.sorted_table.launches == before + 1
    want = expand.sorted_table_plain(fused_s, perm, owner, args[5], **tkw)
    torch.testing.assert_close(table, want, rtol=0, atol=0)
    gathered = expand.expand_keys_plain(
        *args, **kw, exact_cull=exact_cull)[1].index_select(1, perm)
    torch.testing.assert_close(table, gathered, rtol=0, atol=0)
    if exact_cull:
        assert bool((fused_s == kw["sentinel"]).any()), "nothing culled"


# a warp takes an 8x4 pixel block where the shape allows, so its cull
# rectangle spans rows at every shape; (48, 2) falls back to row-major
# warps that span rows, (12, 4) also to a partial last warp
def test_render_graph_frame_is_the_capped_and_the_exact_frame(dev,
                                                              tmp_path):
    """The renderer's frame, one CUDA graph replay at the fitted key
    capacity, is bit for bit the eager capped frame and the exact frame;
    a replay after a new pose gives that pose's frame, and a returned
    frame outlives the next replay."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as sl

    xyz, feats, invalid = make_scene(200, 7)
    ply = str(tmp_path / "scene.ply")
    sl.to_ply(sl.create_scene(xyz[~invalid], sl.SceneConfig(),
                              features=feats[~invalid], device="cpu"), ply)
    turn = np.eye(4, dtype=np.float32)
    turn[:3, :3] = [[np.cos(0.08), 0, np.sin(0.08)], [0, 1, 0],
                    [-np.sin(0.08), 0, np.cos(0.08)]]
    turn[:3, 3] = [0.1, -0.05, -0.3]
    r = render.GaussianPointRenderer(
        render.RendererConfig(parquet_paths=[ply], image_height=64,
                              image_width=64, camera_intrinsics=make_K()),
        np.stack([np.eye(4, dtype=np.float32), turn]), device=dev)
    qs, ts = render.se3_to_qt(r.poses)
    s = r.scene
    frames = []
    for i in (0, 1, 0):
        got = r.render(qs[i], ts[i])
        eager, over = r.render_capped(qs[i], ts[i])
        exact = torch.clamp(R.rasterize(
            s.xyz, s.features, s.invalid, qs[i], ts[i], r.camera, r.rcfg,
            point_object_id=s.object_id).rgb, 0.0, 1.0)
        assert torch.equal(got, eager) and torch.equal(got, exact), i
        assert int(over) == 0
        frames.append(got)
    assert r.captures == 1 and r.graph is not None
    assert not torch.equal(frames[0], frames[1])
    assert torch.equal(frames[0], frames[2])
    kept = frames[1].clone()
    r.render(qs[0], ts[0])
    assert torch.equal(frames[1], kept)
    assert int(r.over_cap) == 0


@pytest.mark.cuda
def test_a_frame_on_the_host_is_the_rounded_frame_in_its_own_pinned_block(
        dev):
    """``_to_frame`` from a card: the rounded uint8 frame bit for bit, in
    page-locked memory; each held frame keeps its own block."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render

    g = torch.Generator(device=dev).manual_seed(5)
    rgbs = [torch.rand((544, 960, 3), generator=g, device=dev)
            for _ in range(3)]
    held = [render.GaussianPointRenderer._to_frame(x) for x in rgbs]
    for x, got in zip(rgbs, held):
        want = torch.round(x * 255).to(torch.uint8).cpu().numpy()
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert torch.from_numpy(got).is_pinned()
    assert len({a.ctypes.data for a in held}) == 3


ATTR_TOL = dict(rtol=2e-6, atol=1e-6, equal_nan=True)
# a camera pose in the world and three per-object poses (xyzw, t)
POSE = (np.asarray([0.05, -0.02, 0.01, 1.0], np.float32) / np.float32(
    np.linalg.norm([0.05, -0.02, 0.01, 1.0])), np.asarray([0.1, 0.0, -0.3],
                                                         np.float32))
OBJECT_POSES = (
    np.asarray([POSE[0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0998, 0.0, 0.995]],
               np.float32),
    np.asarray([POSE[1], [0.0, 0.0, 0.0], [0.2, -0.1, 0.05]], np.float32))


def _attr_scene(kind, n=160):
    """(xyz, features, invalid) numpy: the odd scene (zero rows, points
    behind the camera, at its centre and on its plane), with NaN and inf
    in some feature columns for "nonfinite", or a seeded Truck-like scene
    of n points (60% in a box in front of the camera, the rest on a shell
    behind and beside it; ``_attr_args`` takes 200,000 by default)."""
    if kind == "truck":
        return make_truck_scene(n)
    xyz, feats, invalid = make_odd_scene(n)
    if kind == "nonfinite":
        for row, col, val in ((20, 0, np.nan), (21, 5, np.inf), (22, 7, np.nan),
                              (23, 9, np.nan), (24, 30, -np.inf),
                              (25, 55, np.nan), (26, 6, -np.inf)):
            feats[row, col] = val
        xyz[27, 1] = np.nan
    return xyz, feats, invalid


def _attr_args(dev, kind, objects, n=None):
    xyz, feats, invalid = _attr_scene(kind, n or (200_000 if kind == "truck"
                                                  else 160))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    if objects:
        q, t = map(to, OBJECT_POSES)
        ids = to(np.random.default_rng(5).integers(0, 3, len(xyz)).astype(
            np.int32))
    else:
        (q, t), ids = map(to, POSE), None
    return to(xyz), to(feats), to(invalid), q, t, ids


def _assert_same_attrs(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **ATTR_TOL)
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(torch.isinf(g), torch.isinf(w))


@pytest.mark.parametrize("kind", ["odd", "nonfinite"])
@pytest.mark.parametrize("band", [0, 1, 3])
@pytest.mark.parametrize("objects", [False, True])
@pytest.mark.parametrize("row0", [0, 40])
def test_point_attributes_matches_plain(dev, kind, band, objects, row0):
    """compute_raw_attrs without grad (the kernel, one launch) against
    compute_point_attributes (``point_attributes_plain``) and against
    compute_raw_attrs' autograd path, on the odd scene's guard rows."""
    xyz, feats, _, q, t, ids = _attr_args(dev, kind, objects)
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64, row0)
    before = attrs.point_attributes.launches
    with torch.no_grad():
        raw, radius = R.compute_raw_attrs(xyz, feats, q, t, cam, band, ids)
        plain = attrs.point_attributes_plain(xyz, feats, q, t, cam.K, band,
                                             row0, ids)
    assert attrs.point_attributes.launches == before + 1
    x = xyz.clone().requires_grad_(True)
    raw_g, radius_g = R.compute_raw_attrs(x, feats, q, t, cam, band, ids)
    assert raw_g.uv.requires_grad
    assert attrs.point_attributes.launches == before + 1
    got = tuple(raw) + (radius,)
    _assert_same_attrs(got, plain)
    _assert_same_attrs(got, tuple(a.detach() for a in raw_g) + (radius_g,))
    assert bool(torch.isfinite(raw.uv).any())
    if kind == "nonfinite":
        assert bool(torch.isnan(raw.color).any())


VJP_TOL = dict(rtol=1e-4, atol=1e-5)


def _vjp_cotangents(n, seed, dev):
    """Seeded cotangents of uv, conic, opacity and colour."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
            for s in ((n, 2), (n, 4), (n,), (n, 3))]


@pytest.mark.parametrize("kind", ["scene", "odd"])
@pytest.mark.parametrize("band", [0, 1, 2, 3])
@pytest.mark.parametrize("objects", [False, True])
@pytest.mark.parametrize("row0", [0, 40])
def test_point_attributes_vjp_matches_plain(dev, kind, band, objects, row0):
    """The attribute-VJP kernel (one launch) against autograd of the plain
    version (``point_attributes_vjp_plain``) for seeded cotangents on every
    row, the odd scene's guard rows included: finite on every row, and
    within the tolerance of ``test_torch_attributes_vjp.py``."""
    if kind == "scene":
        xyz, feats, _ = make_scene(160, 3)
        to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        xyz, feats = to(xyz), to(feats)
        _, _, _, q, t, ids = _attr_args(dev, "odd", objects)
    else:
        xyz, feats, _, q, t, ids = _attr_args(dev, kind, objects)
    K = torch.from_numpy(make_K()).to(dev)
    cots = _vjp_cotangents(len(xyz), 100 * band + 10 * objects + row0, dev)
    before = attrs.point_attributes_vjp.launches
    got = attrs.point_attributes_vjp(xyz, feats, q, t, K, band, row0, ids,
                                     *cots)
    assert attrs.point_attributes_vjp.launches == before + 1
    want = attrs.point_attributes_vjp_plain(xyz, feats, q, t, K, band, row0,
                                            ids, *cots)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(w).all())
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, **VJP_TOL)
    # the SH columns above the band take the band mask's zero gradient
    keep = (band + 1) ** 2
    sh = got[1][:, 8:].reshape(-1, 3, 16)
    assert not bool(sh[:, :, keep:].any())
    assert bool(sh[:, :, :keep].any())


def test_point_attributes_vjp_repeats_its_bits_on_a_truck_scene(dev):
    """At the Truck cell's 428,687 points two launches give the same bits
    (each row is written once, nothing summed across threads), within the
    tolerance of autograd of the plain version."""
    xyz, feats, _, q, t, _ = _attr_args(dev, "truck", False, n=428_687)
    K = torch.from_numpy(make_K(960, 544, 580.0)).to(dev)
    cots = _vjp_cotangents(len(xyz), 428_687, dev)
    first = attrs.point_attributes_vjp(xyz, feats, q, t, K, 3, 0, None,
                                       *cots)
    second = attrs.point_attributes_vjp(xyz, feats, q, t, K, 3, 0, None,
                                        *cots)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    want = attrs.point_attributes_vjp_plain(xyz, feats, q, t, K, 3, 0, None,
                                            *cots)
    for g, w in zip(first, want):
        torch.testing.assert_close(g, w, **VJP_TOL)


def test_rasterize_fwd_ctx_takes_the_kernel_pair_without_a_tape(dev):
    """On a card without pose gradients the attributes run the forward
    kernel under no_grad (autograd saves no tensor) and ``attrs_vjp`` is
    one launch of the VJP kernel; with pose gradients the tape, as on the
    CPU, and no attribute kernel."""
    xyz, feats, invalid = (torch.from_numpy(a).to(dev)
                           for a in make_scene(200, 7))
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    cfg = R.RasterizerConfig(tile_size=32)
    q, t = (torch.from_numpy(a).to(dev) for a in (Q_ID, T_ID))
    counts = []
    for pose in (False, True):
        saved = []
        fwd0 = attrs.point_attributes.launches
        vjp0 = attrs.point_attributes_vjp.launches
        with torch.autograd.graph.saved_tensors_hooks(
                lambda x: saved.append(x) or x, lambda x: x):
            out, ctx, vjp = R.rasterize_fwd_ctx(
                xyz, feats, invalid, q, t, cam, cfg, with_pose_grads=pose)
        d_rgb = torch.ones_like(out.rgb)
        grads, _ = R.rasterize_bwd(ctx, vjp, d_rgb, cam, cfg)
        counts.append((len(saved), attrs.point_attributes.launches - fwd0,
                       attrs.point_attributes_vjp.launches - vjp0,
                       len(grads)))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert counts[0] == (0, 1, 1, 2)
    assert counts[1][0] > 0 and counts[1][1:] == (0, 0, 4)


def test_point_attributes_matches_plain_on_a_truck_scene(dev):
    xyz, feats, _, q, t, _ = _attr_args(dev, "truck", False)
    K = torch.from_numpy(make_K(960, 544, 580.0)).to(dev)
    with torch.no_grad():
        got = attrs.point_attributes(xyz, feats, q, t, K)
        want = attrs.point_attributes_plain(xyz, feats, q, t, K)
    _assert_same_attrs(got, want)


def test_point_attributes_keep_the_cull_and_the_key_total(dev):
    """On the odd scene the kernel's fields give exactly the plain
    version's frustum-cull mask and tile-key total."""
    xyz, feats, invalid, q, t, _ = _attr_args(dev, "odd", False)
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    cfg = R.RasterizerConfig(tile_size=32)
    with torch.no_grad():
        *fields, radius = attrs.point_attributes(xyz, feats, q, t, cam.K)
        *pfields, pradius = attrs.point_attributes_plain(xyz, feats, q, t,
                                                         cam.K)
    totals, masks = [], []
    for raw, rad in ((R.RawAttrs(*fields), radius),
                     (R.RawAttrs(*pfields), pradius)):
        vis = R.frustum_cull_mask(raw.uv, raw.depth, invalid, 64, 64,
                                  cfg.near_plane, cfg.far_plane, (32, 32))
        masks.append(vis)
        totals.append(tiling.point_key_ranges(
            raw.uv, raw.depth, rad, vis, 64, 64, (32, 32),
            cfg.depth_to_sort_key_scale).total)
    assert torch.equal(masks[0], masks[1])
    assert 0 < int(masks[0].sum()) < len(masks[0])
    assert totals[0] == totals[1] > 0
    assert R.key_total(xyz, feats, invalid, q, t, cam, cfg) == totals[1]


def test_point_attributes_graph_reads_the_pose_from_the_card(dev):
    """A FrameGraph of compute_raw_attrs, captured at one pose, replays at
    two others bit for bit as the eager kernel: the kernel reads the pose
    through a pointer into the graph's static inputs."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps.render import FrameGraph

    xyz, feats, _, q, t, _ = _attr_args(dev, "odd", False)
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)

    def frame(qq, tt):
        raw, radius = R.compute_raw_attrs(xyz, feats, qq, tt, cam)
        return tuple(raw) + (radius,)

    with torch.no_grad():
        graph = FrameGraph(frame, (q, t), dev)
        turned = (torch.tensor([0.0, 0.0998, 0.0, 0.995], device=dev),
                  torch.tensor([0.2, -0.1, 0.05], device=dev))
        frames = []
        for qq, tt in ((q, t), turned, (q, t)):
            got = graph(qq, tt)
            want = frame(qq, tt)
            for g, w in zip(got, want):
                assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))
            frames.append(got[0])
    assert not torch.equal(frames[0], frames[1])
    assert torch.equal(frames[0], frames[2])


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (32, 8), (16, 16),
                                  (48, 2), (12, 4)])
@pytest.mark.parametrize("rgb_only", [False, True])
@pytest.mark.parametrize("dense", [False, True])
def test_blend_matches_plain(dev, tile, rgb_only, dense):
    # dense: larger, overlapping splats, so pixels saturate and stop early
    cfg, cam, raw, radius, invalid, _ = small_frame(
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
    cfg, cam, _, _, _, (xyz, feats, invalid) = small_frame(dev)
    counters = (attrs.point_attributes, expand.slot_keys,
                expand.sorted_table, histogram.tile_ranges, blend.blend_forward)
    before = [f.launches for f in counters]
    out = R.rasterize(xyz, feats, invalid, torch.from_numpy(Q_ID).to(dev),
                      torch.from_numpy(T_ID).to(dev), cam, cfg)
    assert [f.launches - b
            for f, b in zip(counters, before)] == [1] * 5
    assert out.rgb.shape == (64, 64, 3) and out.rgb.is_cuda
    assert bool(torch.isfinite(out.rgb).all()) and float(out.rgb.max()) > 0


@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (32, 8), (16, 16),
                                  (48, 2)])
@pytest.mark.parametrize("dense", [False, True])
def test_blend_backward_matches_plain(dev, tile, dense):
    cfg, cam, raw, radius, invalid, _ = small_frame(
        dev, tile, n=2000 if dense else 200, scale_shift=1.0 if dense else 0.0)
    keys, table, _ = R.build_keys(raw, radius, invalid, cam, cfg)
    kw = dict(tile=tile, tiles_x=cam.width // tile[0],
              tiles_y=cam.height // tile[1])
    cfin = blend.blend_forward(table, keys.tile_start, keys.tile_end,
                               rgb_only=True, **kw)[..., 0:3].contiguous()
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=tuple(cfin.shape)).astype(np.float32)).to(dev)
    before = blend.blend_backward.launches
    got, img = blend.blend_backward(table, keys.tile_start, keys.tile_end,
                                    g, cfin, **kw)
    again, img2 = blend.blend_backward(table, keys.tile_start,
                                       keys.tile_end, g, cfin, **kw)
    assert blend.blend_backward.launches == before + 2
    want, img_p = blend.blend_backward_plain(
        table, keys.tile_start, keys.tile_end, g, cfin, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(img, img2)
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10]
    torch.testing.assert_close(got[rows], want[rows], rtol=1e-3, atol=5e-4)
    torch.testing.assert_close(got[11], want[11], rtol=0, atol=0)
    assert float(got[[9, 12, 13, 14, 15]].abs().max()) == 0.0
    torch.testing.assert_close(img, img_p, rtol=0, atol=1e-4)
    assert float(want[11].sum()) > 0


def _segments(dev, seed, n=5000, long_every=0):
    """Rows, offsets and counts of up to 5 slots a point (every 7th point
    none); with long_every, every long_every-th point takes 9-200 slots
    (the kernel's warp path)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, n).astype(np.int32)
    counts[::7] = 0
    if long_every:
        counts[3::long_every] = rng.integers(9, 201, len(counts[3::long_every]))
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    cols = int(counts.sum()) + 37  # trailing lanes of no point
    rows = rng.normal(size=(12, cols)).astype(np.float32)
    rows[:, counts.sum():] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (rows, offsets, counts)]


def test_segment_reduce_matches_plain(dev):
    args = _segments(dev, 3)
    before = sr.segment_reduce.launches
    got = sr.segment_reduce(*args)
    assert sr.segment_reduce.launches == before + 1
    want = sr.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (12, 5000)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("num_rows", [12, 2, 16])
@pytest.mark.parametrize("long_every", [0, 50])
def test_segment_reduce_sorted_matches_plain(dev, num_rows, long_every):
    """K5 through a random inverse permutation: equal to its plain version
    (the regroup, then the slot-order sum) and to the unsorted kernel on
    the unpermuted rows, bit for bit."""
    rows, offsets, counts = _segments(dev, 4, long_every=long_every)
    rows = torch.cat([rows] * 2)[:num_rows].contiguous()
    rng = np.random.default_rng(9)
    orig_slot = torch.from_numpy(rng.permutation(rows.shape[1])).to(dev)
    inv = tiling.inverse_permutation(orig_slot)
    sorted_rows = torch.empty_like(rows)
    sorted_rows[:, inv.long()] = rows  # sorted lane inv[k] holds slot k
    before = sr.segment_reduce_sorted.launches
    got = sr.segment_reduce_sorted(sorted_rows, inv, offsets, counts)
    assert sr.segment_reduce_sorted.launches == before + 1
    want = sr.segment_reduce_sorted_plain(sorted_rows, inv, offsets, counts)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, sr.segment_reduce(rows, offsets, counts),
                               rtol=0, atol=0)


def test_train_step_launches_every_kernel(dev, monkeypatch):
    """One train step launches each kernel of its path once, and neither
    the unsorted segment sum nor the regroup of the backward's rows to
    pre-sort order (the segment sum reads them through the inverse key
    permutation)."""
    regroups = []
    regroup = tiling.regroup_rows_by_slot
    monkeypatch.setattr(tiling, "regroup_rows_by_slot",
                        lambda *a, **kw: regroups.append(1) or regroup(
                            *a, **kw))
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    step = trainer.make_train_step(config, 64, 64, device=dev)
    gt = torch.from_numpy((np.random.default_rng(1).random((64, 64, 3))
                           * 255).astype(np.uint8)).to(dev)
    counters = (expand.slot_keys, expand.sorted_table, histogram.tile_ranges,
                blend.blend_forward, blend.blend_backward,
                sr.segment_reduce_sorted, sr.segment_reduce,
                attrs.point_attributes, attrs.point_attributes_vjp)
    before = [f.launches for f in counters]
    new, metrics, aux = step(state, gt, torch.from_numpy(Q_ID).to(dev),
                             torch.from_numpy(T_ID).to(dev),
                             torch.from_numpy(make_K()).to(dev), 3)
    # the step's attributes take the kernel pair, no autograd tape
    assert [f.launches - b
            for f, b in zip(counters, before)] == [1] * 6 + [0, 1, 1]
    assert regroups == []
    assert np.isfinite(float(metrics["loss"]))
    assert bool(torch.isfinite(aux["grad_features"]).all())
    assert float(aux["grad_features"].abs().max()) > 0
    assert not torch.equal(new.scene.features, state.scene.features)


@pytest.mark.parametrize("exact_cull", [False, True])
@pytest.mark.parametrize("cap_of_total", [2.0, 1.0, 0.5, 0.05])
def test_capped_slot_keys_matches_plain(dev, exact_cull, cap_of_total):
    """K1a in its capped mode (the key total read from the device): equal
    to its capped plain version, with the capacity above, at and below the
    key total; its live slots are the exact mode's, the rest padding."""
    cfg, cam, raw, radius, invalid, _ = small_frame(dev, n=2000,
                                                    scale_shift=1.0)
    args, kw = _expand_inputs(cfg, cam, raw, radius, invalid,
                              nonfinite=True)
    total = kw["total"]
    cap = max(int(total * cap_of_total), 1)
    capped = dict(kw, total=cap, exact_cull=exact_cull)
    key_total = torch.tensor(total, dtype=torch.int64, device=dev)
    before = expand.slot_keys.launches
    fused, owner = expand.slot_keys(*args, **capped, key_total=key_total)
    assert expand.slot_keys.launches == before + 1
    fused_p, owner_p = expand.slot_keys_plain(*args, **capped,
                                              key_total=key_total)
    torch.testing.assert_close(fused, fused_p, rtol=0, atol=0)
    torch.testing.assert_close(owner, owner_p, rtol=0, atol=0)
    exact, exact_owner = expand.slot_keys(*args, **kw, exact_cull=exact_cull)
    live = min(total, cap)
    torch.testing.assert_close(fused[:live], exact[:live], rtol=0, atol=0)
    torch.testing.assert_close(owner[:live], exact_owner[:live], rtol=0,
                               atol=0)
    assert bool((fused[live:] == kw["sentinel"]).all())
    assert bool((owner[live:] == 0).all())


@pytest.fixture(scope="module")
def full_frame(dev):
    """The Truck cell's frame through the main path's stages: the 428,687
    points of ``make_truck_scene`` from the identity pose at 960x544,
    32x32 tiles, the exact tile cull; K1a's inputs as ``_expand_inputs``
    gives them."""
    xyz, feats, invalid = (torch.from_numpy(a).to(dev)
                           for a in make_truck_scene(428_687))
    cam = R.Camera(torch.from_numpy(make_K(960, 544, 580.0)).to(dev), 960,
                   544)
    cfg = R.RasterizerConfig(tile_size=32)
    q, t = torch.from_numpy(Q_ID).to(dev), torch.from_numpy(T_ID).to(dev)
    raw, radius = R.compute_raw_attrs(xyz, feats, q, t, cam)
    args, kw = _expand_inputs(cfg, cam, raw, radius, invalid)
    keys, table, _ = R.build_keys(raw, radius, invalid, cam, cfg)
    return SimpleNamespace(
        scene=(xyz, feats, invalid), q=q, t=t, cam=cam, cfg=cfg, args=args,
        kw=dict(kw, exact_cull=cfg.exact_tile_cull), keys=keys, table=table,
        num_tiles=30 * 17, blend_kw=dict(tile=(32, 32), tiles_x=30,
                                         tiles_y=17))


def test_keys_at_the_full_width_frame_match_plain(dev, full_frame):
    """K1a, K1b, K2 and tile_counts at the full-width frame, bit for bit
    their plain versions; the sorted table also the plain pre-sort table
    gathered by the sort's permutation, and with the permutation and K2's
    ranges the main path's; K2 also torch.searchsorted; K1a in its capped
    mode (the key total read from the device) at 2^18 keys, below the
    frame's total, and at the fitted capacity, its capped plain version."""
    f = full_frame
    att = f.args[5]
    fused, owner = expand.slot_keys(*f.args, **f.kw)
    fused_p, owner_p = expand.slot_keys_plain(*f.args, **f.kw)
    fused_s, perm = torch.sort(fused, stable=True)
    tkw = {k: f.kw[k] for k in ("tiles_u", "tile_w", "tile_h", "dbits",
                                "sentinel")}
    table = expand.sorted_table(fused_s, perm, owner, att, **tkw)
    pairs = {
        "K1a fused": (fused, fused_p), "K1a owner": (owner, owner_p),
        "K1b table": (table, expand.sorted_table_plain(fused_s, perm, owner,
                                                       att, **tkw)),
        "pre-sort table gathered": (table, expand.expand_keys_plain(
            *f.args, **f.kw)[1].index_select(1, perm)),
        "main path's table": (table, f.table),
        "main path's orig_slot": (perm, f.keys.orig_slot)}
    dbits, fused_m = f.kw["dbits"], f.keys.fused
    bounds = histogram.tile_ranges(fused_m, dbits, f.num_tiles)
    pairs.update({
        "K2": (bounds, histogram.tile_ranges_plain(fused_m, dbits,
                                                   f.num_tiles)),
        "K2 against torch.searchsorted": (bounds, torch.searchsorted(
            (fused_m >> dbits).contiguous(), torch.arange(
                f.num_tiles + 1, dtype=torch.int32, device=dev)).int()),
        "K2 against the main path's ranges": (bounds, torch.cat(
            [f.keys.tile_start, f.keys.tile_end[-1:]]))})
    counts = torch.full((3,), -1, dtype=torch.int64, device=dev)
    counts_p = torch.empty(3, dtype=torch.int64, device=dev)
    histogram.tile_counts(bounds, counts)
    histogram.tile_counts_plain(bounds, counts_p)
    pairs["tile_counts"] = (counts, counts_p)
    total = f.kw["total"]
    assert total > 2 ** 18
    key_total = torch.tensor(total, dtype=torch.int64, device=dev)
    for cap in (2 ** 18, trainer.fit_key_cap(total)):
        kw = dict(f.kw, total=cap)
        got = expand.slot_keys(*f.args, **kw, key_total=key_total)
        want = expand.slot_keys_plain(*f.args, **kw, key_total=key_total)
        pairs[f"capped K1a fused at {cap}"] = (got[0], want[0])
        pairs[f"capped K1a owner at {cap}"] = (got[1], want[1])
    assert [n for n, (a, b) in pairs.items() if not torch.equal(a, b)] == []
    assert 0 < int(bounds[-1]) <= total


def test_point_attributes_at_the_full_width_frame_are_the_plain_bits(
        dev, full_frame):
    """The attribute kernel at the full-width frame: every field bit for
    bit its plain version's, NaN where it has NaN."""
    f = full_frame
    xyz, feats, _ = f.scene
    with torch.no_grad():
        got = attrs.point_attributes(xyz, feats, f.q, f.t, f.cam.K)
        want = attrs.point_attributes_plain(xyz, feats, f.q, f.t, f.cam.K)
    for g, w in zip(got, want):
        assert bool((torch.eq(g, w) | (g.isnan() & w.isnan())).all())


@pytest.mark.parametrize("rgb_only", [True, False])
def test_blend_at_the_full_width_frame_matches_plain(dev, full_frame,
                                                      rgb_only):
    """K3 at the full-width frame within the image gates of its plain
    version, the count differing on under 0.01% of the pixels; the main
    path's full-output frame within them of the plain blend of its
    keys."""
    f = full_frame
    k = f.keys
    got = blend.blend_forward(f.table, k.tile_start, k.tile_end,
                              rgb_only=rgb_only, **f.blend_kw)
    want = blend.blend_forward_plain(f.table, k.tile_start, k.tile_end,
                                     rgb_only=rgb_only, **f.blend_kw)
    torch.testing.assert_close(got[..., 0:3], want[..., 0:3], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(got[..., 6], want[..., 6], rtol=0, atol=1e-4)
    if rgb_only:
        return
    depth = lambda o: o[..., 3] / torch.clamp_min(o[..., 4], 1e-6)  # noqa: E731
    torch.testing.assert_close(depth(got), depth(want), rtol=0, atol=5e-4)
    assert int((got[..., 5] != want[..., 5]).sum()) <= 1e-4 * 960 * 544
    out = R.rasterize(*f.scene, f.q, f.t, f.cam, f.cfg)
    plain = R._assemble(want, f.cam, f.cfg)
    for name, atol in (("rgb", 1e-4), ("alpha", 1e-4), ("depth", 5e-4)):
        torch.testing.assert_close(getattr(out, name), getattr(plain, name),
                                   rtol=0, atol=atol)
    assert int((out.count != plain.count).sum()) <= 1e-4 * 960 * 544
    assert bool(torch.isfinite(out.rgb).all()) and float(out.rgb.max()) > 0


def test_blend_backward_and_segment_sum_at_the_full_width_frame(dev,
                                                                 full_frame):
    """K4 at the full-width frame with a seeded image cotangent and the
    forward's rgb: two runs bit for bit; its count differing from its plain
    version's on under 0.01% of the live keys, its rows within the
    gradient gate on the others, the |grad_uv| image within 1e-4, the
    unused rows zero. K5 on its rows through the inverse permutation: bit
    for bit its plain version and the unsorted kernel on the regrouped
    rows."""
    f = full_frame
    k = f.keys
    cfin = blend.blend_forward(f.table, k.tile_start, k.tile_end,
                               rgb_only=True, **f.blend_kw)
    cfin = cfin[..., 0:3].contiguous()
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(cfin.shape)).astype(np.float32)).to(dev)
    args = (f.table, k.tile_start, k.tile_end, g, cfin)
    got, img = blend.blend_backward(*args, **f.blend_kw)
    again, img2 = blend.blend_backward(*args, **f.blend_kw)
    assert torch.equal(got, again) and torch.equal(img, img2)
    want, img_p = blend.blend_backward_plain(*args, **f.blend_kw)
    live = int(k.tile_end[-1])
    same = got[11, :live] == want[11, :live]
    assert int((~same).sum()) <= 1e-4 * live
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10]
    excess = ((got[rows] - want[rows]).abs()
              - (5e-4 + 1e-3 * want[rows].abs()))[:, :live][:, same]
    assert float(excess.max()) <= 0
    torch.testing.assert_close(img, img_p, rtol=0, atol=1e-4)
    assert float(got[[9, 12, 13, 14, 15]].abs().max()) == 0.0
    assert float(want[11].sum()) > 0
    rows = got[0:12]
    inv = tiling.inverse_permutation(k.orig_slot)
    seg = sr.segment_reduce_sorted(rows, inv, k.offsets, k.counts)
    assert torch.equal(seg, sr.segment_reduce_sorted_plain(
        rows, inv, k.offsets, k.counts))
    assert torch.equal(seg, sr.segment_reduce(
        tiling.regroup_rows_by_slot(rows, k.orig_slot), k.offsets, k.counts))


def test_window_graph_equals_eager_steps(dev):
    """make_train_step(scan_steps=3) on the card: one CUDA graph a window,
    replayed from a given state, ends in the state and losses of three
    eager exact steps, bit for bit; the replayed state is passed back
    as it is, a replaced one is copied in."""
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    rng = np.random.default_rng(1)
    gts = torch.from_numpy((rng.random((3, 64, 64, 3)) * 255).astype(
        np.uint8)).to(dev)
    qs = torch.from_numpy(np.tile(Q_ID, (3, 1))).to(dev)
    ts = torch.from_numpy(rng.normal(0, 0.02, (3, 3)).astype(
        np.float32)).to(dev)
    Ks = torch.from_numpy(np.tile(make_K(), (3, 1, 1))).to(dev)
    step = trainer.make_train_step(config, 64, 64, device=dev)
    eager, losses = state, []
    for i in range(3):
        eager, m, _ = step(eager, gts[i], qs[i], ts[i], Ks[i], 3)
        losses.append(m["loss"])
    window = trainer.make_train_step(config, 64, 64, scan_steps=3,
                                     device=dev, key_cap=4096)
    window(state, gts, qs, ts, Ks, 3)  # warm-up and capture, then a replay
    assert len(window.graphs) == 1
    got, metrics, _ = window(state, gts, qs, ts, Ks, 3)
    torch.testing.assert_close(metrics["loss"], torch.stack(losses),
                               rtol=0, atol=0)
    for x, y in zip(checkpoint.state_leaves(got),
                    checkpoint.state_leaves(eager)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    again, _, _ = window(got, gts, qs, ts, Ks, 3)  # the static state itself
    assert again.scene.features.data_ptr() == got.scene.features.data_ptr()
    assert int(again.feat_opt.count) == 6


def test_window_of_8_launches_the_attribute_pair_once_a_step(dev):
    """A captured window of 8 steps holds the attribute kernel and the
    attribute-VJP kernel 8 times each, and so every other kernel of the
    step (K1a, K1b, K2, K3, K4, K5): the wrappers count 8 in the eager
    warm-up and 8 in the capture, the tile counters 8 in the capture alone
    (the warm-up fills none), and the unsorted segment sum none; a replay
    ticks no counter (it replays the launches it captured)."""
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    inputs = _window_inputs(dev, k=8)
    window = trainer.make_train_step(config, 64, 64, scan_steps=8,
                                     device=dev, key_cap=4096)
    counters = (attrs.point_attributes, attrs.point_attributes_vjp,
                expand.slot_keys, expand.sorted_table, histogram.tile_ranges,
                blend.blend_forward, blend.blend_backward,
                sr.segment_reduce_sorted, histogram.tile_counts,
                sr.segment_reduce)
    before = [f.launches for f in counters]
    state = window(state, *inputs, 3)[0]
    assert (window.mode, window.captures) == ("graph", 1)
    assert [f.launches - b for f, b in zip(counters, before)] == (
        [16] * 8 + [8, 0])
    before = [f.launches for f in counters]
    got = window(state, *inputs, 3)[0]
    assert [f.launches - b for f, b in zip(counters, before)] == [0] * 10
    assert int(got.feat_opt.count) == 16


def _window_inputs(dev, k=3):
    rng = np.random.default_rng(1)
    gts = torch.from_numpy((rng.random((k, 64, 64, 3)) * 255).astype(
        np.uint8)).to(dev)
    qs = torch.from_numpy(np.tile(Q_ID, (k, 1))).to(dev)
    ts = torch.from_numpy(rng.normal(0, 0.02, (k, 3)).astype(
        np.float32)).to(dev)
    Ks = torch.from_numpy(np.tile(make_K(), (k, 1, 1))).to(dev)
    return gts, qs, ts, Ks


def test_window_captures_before_its_constants_reach_the_card(dev):
    """A window whose warm-up is the first train step on the card (the
    SSIM window and Adam's bias tables not copied there yet, as in a
    freshly spawned rank) captures: those constants go over from pinned
    memory without a host sync, which the warm-up's sync-debug mode
    "error" would refuse."""
    from taichi_3d_gaussian_splatting_tpu_torch.training import loss

    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    inputs = _window_inputs(dev)
    loss._WINDOWS.clear()
    trainer._BIAS_TABLES.clear()
    window = trainer.make_train_step(config, 64, 64, scan_steps=3,
                                     device=dev, key_cap=4096)
    got = window(state, *inputs, 3)[0]
    assert (window.mode, window.captures) == ("graph", 1)
    assert int(got.feat_opt.count) == 3
    assert loss._WINDOWS and trainer._BIAS_TABLES


def test_dp_window_graph_over_nccl_equals_eager_dp_steps(dev):
    """make_dp_train_step(scan_steps=3) in a group of one over NCCL (in
    this process): the window is one CUDA graph holding its collectives,
    and a replay from a given state ends in the state and losses of three
    eager capped data-parallel steps, bit for bit, and in the state of
    three capped single-device steps on the same f32 targets; the replayed
    state is passed back as it is."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (  # noqa: E501
        make_dp_train_step,
    )

    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    gts, qs, ts, Ks = _window_inputs(dev)
    # one row a step, f32 targets (the trainer stages them so)
    views = [x[:, None] for x in (gts.float() / 255.0, qs, ts, Ks)]
    single = trainer.make_train_step(config, 64, 64, device=dev,
                                     key_cap=4096)
    alone = state
    for i in range(3):
        alone = single(alone, *(v[i, 0] for v in views), 3)[0]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{mh.free_port()}",
        world_size=1, rank=0)
    try:
        capped = make_dp_train_step(config, 64, 64, device=dev,
                                    key_cap=4096)
        eager, losses = state, []
        for i in range(3):
            eager, m, _ = capped(eager, *(v[i] for v in views), 3)
            losses.append(m["loss"])
        window = make_dp_train_step(config, 64, 64, device=dev,
                                    scan_steps=3, key_cap=4096)
        assert window.mode == "graph"
        window(state, *views, 3)  # warm-up and capture, then a replay
        got, metrics, _ = window(state, *views, 3)
        assert (window.captures, len(window.graphs)) == (1, 1)
        assert [c.op for c in capped.collectives] == ["sum", "max"]
        torch.testing.assert_close(metrics["loss"], torch.stack(losses),
                                   rtol=0, atol=0)
        for x, y, z in zip(checkpoint.state_leaves(got),
                           checkpoint.state_leaves(eager),
                           checkpoint.state_leaves(alone)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
            torch.testing.assert_close(x, z, rtol=0, atol=0)
        again, _, _ = window(got, *views, 3)  # the static state itself
        assert again.scene.features.data_ptr() == got.scene.features.data_ptr()
        assert int(again.feat_opt.count) == 6
        assert mh.live_windows() == list(window.graphs.values())
    finally:
        mh.shutdown()  # releases the window's graph before the group goes
    assert not dist.is_initialized() and mh.live_windows() == []
    assert all(g.graph is None for g in window.graphs.values())


def test_window_release_returns_its_pool_and_a_recapture_is_the_first(dev):
    """``_CapturedWindow.release()`` resets the graph and drops its static
    buffers: the card's reserved memory falls by at least nine tenths of
    what the window held (its pool, inputs and state); a second release
    does nothing; the window's next call captures anew and ends bit for
    bit where the first capture's call ended."""
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    inputs = _window_inputs(dev)
    cap = 2 ** 18  # key buffers of tens of MB: a pool that shows
    capped = trainer.make_train_step(config, 64, 64, device=dev, key_cap=cap)
    capped(state, *(x[0] for x in inputs), 3)  # the card's constants
    window = trainer.make_train_step(config, 64, 64, scan_steps=3,
                                     device=dev, key_cap=cap)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    got = window(state, *inputs, 3)[0]
    first = [t.cpu() for t in checkpoint.state_leaves(got)]
    del got
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    (graph,) = window.graphs.values()
    graph.release()
    graph.release()
    assert graph.graph is None and graph.state is None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved()
    assert held - before > 2 ** 20
    assert held - after >= 0.9 * (held - before)
    again = window(state, *inputs, 3)[0]
    assert window.captures == 2
    for x, y in zip(checkpoint.state_leaves(again), first):
        torch.testing.assert_close(x.cpu(), y, rtol=0, atol=0)


def test_window_replays_its_graph_after_a_new_scene_and_a_new_band(dev):
    """The window holds one graph. After a densify-like change (a new scene
    and controller, the optimizer states the graph's own) it replays that
    graph; a call at another SH band releases it and captures anew, and
    the next call replays. Every call ends where three eager capped steps
    from the same state end, bit for bit."""
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    inputs = _window_inputs(dev)
    capped = trainer.make_train_step(config, 64, 64, device=dev,
                                     key_cap=4096)
    window = trainer.make_train_step(config, 64, 64, scan_steps=3,
                                     device=dev, key_cap=4096)

    def eager(s, band):
        for i in range(3):
            s = capped(s, *(x[i] for x in inputs), band)[0]
        return s

    got = window(state, *inputs, 2)[0]
    changed = got._replace(
        scene=got.scene._replace(features=got.scene.features * 0.5 + 0.01),
        ctrl=controller.init_state(got.scene.capacity, device=dev))
    calls = [(changed, 2, 1), (None, 3, 2), (None, 3, 2)]
    for before, band, captures in calls:
        before = got if before is None else before
        want = eager(before, band)  # new tensors: the replay overwrites got
        got = window(before, *inputs, band)[0]
        assert (window.captures, len(window.graphs)) == (captures, 1)
        for x, y in zip(checkpoint.state_leaves(got),
                        checkpoint.state_leaves(want)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("which", [0, 1])  # features, positions
def test_adam_on_the_card_equals_the_host_scalar_update(dev, which):
    """On the card, Adam's update with its count on the device equals, bit
    for bit, the update with host-float bias corrections and rate (which
    PyTorch applies on the card as a multiply by the f32 reciprocal), over
    counts 1-300 and 17,300-17,340, the rate decaying every 3 updates."""
    config = TrainConfig(feature_learning_rate=1e-2,
                         position_learning_rate=1e-3,
                         position_learning_rate_decay_interval=3)
    tx = trainer.make_optimizers(config)[which]
    rng = np.random.default_rng(which)
    param = torch.from_numpy(rng.normal(size=(64, 3)).astype(
        np.float32)).to(dev)
    for start in (0, 17299):
        state = tx.init(param)._replace(
            count=torch.tensor(start, dtype=torch.int64, device=dev))
        for _ in range(300 if start == 0 else 41):
            grad = torch.from_numpy((rng.normal(size=(64, 3))
                                     * 10.0 ** rng.integers(-3, 3)).astype(
                                         np.float32)).to(dev)
            want, mu, nu = host_scalar_adam(tx, grad, state, param)
            param, state = tx.update(grad, state, param)
            assert torch.equal(param, want), int(state.count)
            assert torch.equal(state.mu, mu) and torch.equal(state.nu, nu)
    # why the update divides through trainer._over: on the card a true
    # division by the device scalar rounds otherwise than the division by
    # the host float
    x = torch.from_numpy(rng.random(4096).astype(np.float32) + 0.5).to(dev)
    d = float(np.float32(1.0) - np.float32(0.999) ** np.float32(7))
    assert torch.equal(x / d, trainer._over(x, torch.tensor(d, device=dev)))
    assert not torch.equal(x / d, x / torch.tensor(d, device=dev))
