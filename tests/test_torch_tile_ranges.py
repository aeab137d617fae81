"""The port's tile ranges (``histogram.tile_ranges``, plain version on the
CPU) against the JAX package's: the exclusive cumsum of its Pallas
``bucket_histogram`` (interpret mode) over the sorted tile ids, and
``jnp.searchsorted``. Integer bounds, so bit for bit."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import tiling as jtl  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import histogram  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling as ttl  # noqa: E402
from tests.torch_port_scenes import (  # noqa: E402
    Q_ID, T_ID, make_K, make_odd_scene, make_scene,
)


def _check(fused_sorted: np.ndarray, dbits: int, num_tiles: int):
    got = histogram.tile_ranges(torch.from_numpy(fused_sorted), dbits,
                                num_tiles)
    assert got.dtype == torch.int32 and got.shape == (num_tiles + 1,)
    tid = jnp.asarray(fused_sorted) >> dbits
    from_hist = jtl._exclusive_bounds(tid, num_tiles, interpret=True)
    by_search = jnp.searchsorted(tid, jnp.arange(num_tiles + 1),
                                 side="left")
    np.testing.assert_array_equal(got.numpy(), np.asarray(from_hist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(by_search))
    return got.numpy()


def _keys(tids, dkeys, dbits):
    return np.sort((np.asarray(tids, np.int64) << dbits
                    | np.asarray(dkeys, np.int64)).astype(np.int32))


@pytest.mark.parametrize("case", ["empty", "all_sentinel", "single_tile",
                                  "first_and_last", "random"])
def test_tile_ranges_matches_jax(case):
    num_tiles = 510
    dbits = jtl._depth_bits(num_tiles)
    sentinel = ((num_tiles + 1) << dbits) - 1
    rng = np.random.default_rng(3)
    if case == "empty":
        fused = np.zeros((0,), np.int32)
    elif case == "all_sentinel":
        fused = np.full((37,), sentinel, np.int32)
    elif case == "single_tile":
        fused = _keys(np.full(50, 123), rng.integers(0, 1 << dbits, 50), dbits)
    elif case == "first_and_last":
        fused = _keys([0] * 5 + [num_tiles - 1] * 3, rng.integers(0, 9, 8),
                      dbits)
    else:
        tids = rng.integers(0, num_tiles, 5000)
        fused = np.concatenate([
            _keys(tids, rng.integers(0, 1 << dbits, 5000), dbits),
            np.full((11,), sentinel, np.int32)])
    bounds = _check(fused, dbits, num_tiles)
    live = int((fused >> dbits < num_tiles).sum())
    assert bounds[0] == 0 and bounds[-1] == live


@pytest.mark.parametrize("scene", ["seeded", "odd"])
@pytest.mark.parametrize("tile", [(32, 32), (32, 16), (16, 16)])
def test_tile_ranges_of_seeded_frames(scene, tile):
    """The sorted keys of the port's tiling stage on the seeded scenes (the
    exact cull retires keys to the sentinel)."""
    xyz, feats, invalid = (make_scene(200, 7) if scene == "seeded"
                           else make_odd_scene())
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    raw, radius = tr.compute_raw_attrs(
        torch.from_numpy(xyz), torch.from_numpy(feats),
        torch.from_numpy(Q_ID), torch.from_numpy(T_ID), cam)
    cfg = tr.RasterizerConfig(tile_size=tile[0], tile_h=tile[1])
    keys, _, _ = tr.build_keys(raw, radius, torch.from_numpy(invalid), cam,
                               cfg)
    num_tiles = (64 // tile[0]) * (64 // tile[1])
    dbits = ttl._depth_bits(num_tiles)
    assert keys.total > 0
    bounds = _check(keys.fused.numpy(), dbits, num_tiles)
    np.testing.assert_array_equal(keys.tile_start.numpy(), bounds[:-1])
    np.testing.assert_array_equal(keys.tile_end.numpy(), bounds[1:])
