"""The port's tiling stage against the JAX package's
``build_tile_keys_and_table`` (Pallas kernels in interpret mode).

Both stages get the same raw attributes (computed once by JAX), so every
integer must agree exactly: counts, offsets, total, tile ranges, the sort
order and the fused keys. The table rows are copies plus one f32
subtract, so they agree exactly too, but for the one row that each package
computes with its own log. JAX's key_cap stays above the total;
its slots past the total sort after every live key, so the first `total`
sorted slots of both packages are the same keys.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import tiling as jtl  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import expand  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling as ttl  # noqa: E402
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene  # noqa: E402

KEY_CAP = 4096


def _frame(tile, n=200, seed=7):
    xyz, feats, invalid = make_scene(n, seed)
    jcam = jr.Camera(jnp.asarray(make_K()), 64, 64)
    raw, radius = jr.compute_raw_attrs(jnp.asarray(xyz), jnp.asarray(feats),
                                       jnp.asarray(Q_ID), jnp.asarray(T_ID),
                                       jcam)
    t_raw = tr.RawAttrs(*[torch.from_numpy(np.array(x)) for x in raw])
    return (jcam, raw, jnp.asarray(radius), jnp.asarray(invalid), t_raw,
            torch.from_numpy(np.array(radius)), torch.from_numpy(invalid))


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
@pytest.mark.parametrize("exact_tile_cull", [False, True])
def test_build_keys_matches_jax(tile, exact_tile_cull):
    jcam, raw, radius, invalid, t_raw, t_radius, t_invalid = _frame(tile)
    jcfg = jr.RasterizerConfig(tile_size=tile[0], tile_h=tile[1],
                               key_cap=KEY_CAP, interpret=True,
                               exact_tile_cull=exact_tile_cull)
    jkeys, jtable, jvis = jr.build_keys(raw, radius, invalid, jcam, jcfg)
    tcfg = tr.RasterizerConfig(tile_size=tile[0], tile_h=tile[1],
                               exact_tile_cull=exact_tile_cull)
    tcam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    keys, table, vis = tr.build_keys(t_raw, t_radius, t_invalid, tcam, tcfg)

    total = keys.total
    assert 0 < total == int(jkeys.total) < KEY_CAP
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    for name in ("counts", "offsets", "tile_start", "tile_end"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      np.asarray(getattr(jkeys, name)),
                                      err_msg=name)
    # the stable sort order: pre-sort slot of each sorted key
    np.testing.assert_array_equal(keys.orig_slot.numpy(),
                                  np.asarray(jkeys.orig_slot)[:total])
    # table rows 0..9 (row 10, the point index, is not kept by JAX). Row 5,
    # log(rescale * opacity), is each package's own f32 log: XLA's and
    # torch's agree to one ulp; every other row is a copy or one subtract.
    jt = np.asarray(jtable)[:10, :total]
    copied = [0, 1, 2, 3, 4, 6, 7, 8, 9]
    np.testing.assert_array_equal(table[copied].numpy(), jt[copied])
    np.testing.assert_allclose(table[5].numpy(), jt[5], rtol=2.5e-7, atol=0)
    assert table.shape == (16, total)

    # fused keys rebuilt from JAX's own outputs: owning point of each
    # pre-sort slot, JAX's tile of each sorted key, its depth key
    num_tiles = (64 // tile[0]) * (64 // tile[1])
    dbits = jtl._depth_bits(num_tiles)
    sentinel = ((num_tiles + 1) << dbits) - 1
    offsets = np.asarray(jkeys.offsets)
    counts = np.asarray(jkeys.counts)
    owner = np.repeat(np.arange(len(counts)), counts)
    point = owner[np.asarray(jkeys.orig_slot)[:total]]
    dkey = np.clip((np.asarray(raw.depth) * 100.0).astype(np.int32), 0,
                   (1 << dbits) - 1)
    tid = np.asarray(jkeys.tile_of_slot)[:total]
    live = np.arange(total) < np.asarray(jkeys.tile_end)[-1]
    want = np.where(live, (tid << dbits) | dkey[point], sentinel)
    np.testing.assert_array_equal(keys.fused.numpy(), want)
    np.testing.assert_array_equal(table[10].numpy(), point.astype(np.float32))
    assert (offsets[point] <= keys.orig_slot.numpy()).all()
    if exact_tile_cull:  # the cull retired keys: sentinels past the ranges
        assert (~live).sum() > 0


def test_build_tile_keys_without_table_matches_jax():
    jcam, raw, radius, invalid, t_raw, t_radius, t_invalid = _frame((32, 32))
    vis = np.asarray(raw.depth) > 0.8
    jkeys = jtl.build_tile_keys(raw.uv, raw.depth, radius, jnp.asarray(vis),
                                64, 64, 32, KEY_CAP, 100.0, interpret=True)
    keys = ttl.build_tile_keys(t_raw.uv, t_raw.depth, t_radius,
                               torch.from_numpy(vis), 64, 64, 32, 100.0)
    for name in ("counts", "offsets", "tile_start", "tile_end"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      np.asarray(getattr(jkeys, name)))
    np.testing.assert_array_equal(keys.orig_slot.numpy(),
                                  np.asarray(jkeys.orig_slot)[:keys.total])


def test_tile_bbox_matches_jax():
    rng = np.random.default_rng(5)
    uv = rng.uniform(-40, 110, (300, 2)).astype(np.float32)
    for radius in (rng.uniform(0, 40, 300).astype(np.float32),
                   rng.uniform(0, 40, (300, 2)).astype(np.float32)):
        for tile in (32, (32, 16)):
            jb = jtl.tile_bbox(jnp.asarray(uv), jnp.asarray(radius), 64, 64,
                               tile)
            tb = ttl.tile_bbox(torch.from_numpy(uv), torch.from_numpy(radius),
                               64, 64, tile)
            for a, b in zip(jb, tb):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_expand_keys_decodes_u_major():
    """One point covering a 3x2 tile block: slots walk down the bbox
    columns first (du = j // h, dv = j % h)."""
    one = lambda v: torch.tensor([v], dtype=torch.int32)  # noqa: E731
    att = torch.zeros((10, 1))
    fused, table = expand.expand_keys(
        one(0), one(6), one(5), one(1), one(2), att, total=6, tiles_u=4,
        tile_w=8, tile_h=8, dbits=10, sentinel=(13 << 10) - 1,
        exact_cull=False)
    tids = [1 + j // 2 + (j % 2) * 4 for j in range(6)]
    assert fused.tolist() == [(t << 10) + 5 for t in tids]
    assert table[10].tolist() == [0.0] * 6 and table[11:].abs().sum() == 0


def _expand_inputs(tile, exact_tile_cull):
    """The expansion's inputs from the port's own tiling stage on the
    JAX-computed raw attributes of the seeded scene, with some point
    columns made non-finite (read as 0)."""
    _, _, _, _, t_raw, t_radius, t_invalid = _frame(tile)
    cfg = tr.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    visible = tr.frustum_cull_mask(t_raw.uv, t_raw.depth, t_invalid, 64, 64,
                                   cfg.near_plane, cfg.far_plane, tile)
    r = ttl.point_key_ranges(t_raw.uv, t_raw.depth, t_radius, visible, 64,
                             64, tile, cfg.depth_to_sort_key_scale)
    tiles_u = 64 // tile[0]
    num_tiles = tiles_u * (64 // tile[1])
    dbits = ttl._depth_bits(num_tiles)
    att = tr.attr_columns(t_raw)
    att[2, ::7] = float("nan")
    att[6, 1::5] = float("inf")
    att[9, 3::11] = -float("inf")
    kw = dict(total=r.total, tiles_u=tiles_u, tile_w=tile[0], tile_h=tile[1],
              dbits=dbits, sentinel=((num_tiles + 1) << dbits) - 1,
              exact_cull=exact_tile_cull)
    return r, att, kw


@pytest.mark.parametrize("tile", [(32, 32), (32, 16)])
@pytest.mark.parametrize("exact_tile_cull", [False, True])
def test_sorted_table_equals_gathered_pre_sort_table(tile, exact_tile_cull):
    """Keys first, table after the sort (the port's two passes) gives the
    pre-sort table of the JAX contract gathered by the sort's permutation,
    bit for bit; the owners are repeat_interleave's."""
    r, att, kw = _expand_inputs(tile, exact_tile_cull)
    args = (r.offsets, r.counts, r.dkey, r.base, r.h, att)
    fused, owner = expand.slot_keys(*args, **kw)
    fused_p, table_p = expand.expand_keys_plain(*args, **kw)
    np.testing.assert_array_equal(fused.numpy(), fused_p.numpy())
    want_owner = np.repeat(np.arange(len(r.counts)), r.counts.numpy())
    assert owner.dtype == torch.int32
    np.testing.assert_array_equal(owner.numpy(), want_owner)
    fused_s, perm = torch.sort(fused, stable=True)
    tkw = {k: kw[k] for k in ("tiles_u", "tile_w", "tile_h", "dbits",
                              "sentinel")}
    table = expand.sorted_table(fused_s, perm, owner, att, **tkw)
    np.testing.assert_array_equal(table.numpy(),
                                  table_p.index_select(1, perm).numpy())
    # the non-finite columns read as 0, and the JAX-contract pre-sort table
    finite = torch.nan_to_num(att, nan=0.0, posinf=0.0, neginf=0.0)
    np.testing.assert_array_equal(
        table.numpy(),
        expand.sorted_table(fused_s, perm, owner, finite, **tkw).numpy())
    assert np.isfinite(table.numpy()).all()
    _, pre = expand.expand_keys(*args, **kw)
    np.testing.assert_array_equal(pre.numpy(), table_p.numpy())
    if exact_tile_cull:
        assert bool((fused_s == kw["sentinel"]).any()), "nothing culled"
