"""The port's segment reduction (K5's plain versions) and the regroup by
original slot against the JAX package's ``segment_reduce`` (Pallas in
interpret mode) and ``regroup_rows_by_slot``.

The segment sums agree to rtol 1e-6, atol 1e-6 (JAX adds through a bf16x3
membership matmul, exact but for the f32 sum order); the regroup is a
permutation and agrees exactly. ``segment_reduce_sorted`` reads rows in
sorted order through the inverse permutation: it equals JAX's regroup
followed by JAX's segment sum, and with the identity the port's own
``segment_reduce`` bit for bit.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import tiling as jt  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops.segment_reduce import (  # noqa: E402
    segment_reduce as j_segment_reduce,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling as tt  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops.segment_reduce import (  # noqa: E402
    segment_reduce,
    segment_reduce_sorted,
)


def _segments(n, seed, max_count=7, trailing=50):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_count, n).astype(np.int32)
    counts[::5] = 0  # points with no key
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    cols = int(counts.sum()) + trailing  # lanes of no point, zero
    rows = np.zeros((12, cols), np.float32)
    rows[:, :counts.sum()] = rng.normal(size=(12, counts.sum()))
    return rows, offsets, counts


@pytest.mark.parametrize("n, seed", [(300, 0), (1500, 1)])
def test_segment_reduce_matches_jax(n, seed):
    rows, offsets, counts = _segments(n, seed)
    want = np.asarray(j_segment_reduce(
        jnp.asarray(rows), jnp.asarray(offsets), jnp.asarray(counts),
        interpret=True))[:, :n]
    got = segment_reduce(*map(torch.from_numpy, (rows, offsets, counts)))
    assert got.shape == (12, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got.numpy()[:, counts == 0].any()


def test_segment_reduce_reads_only_its_segments():
    """Segments need not tile the lanes from 0: each point sums exactly
    [offsets[p], offsets[p] + counts[p])."""
    rows = np.arange(20, dtype=np.float32)[None].repeat(2, 0)
    offsets = np.asarray([3, 10, 0, 19], np.int32)
    counts = np.asarray([2, 4, 0, 1], np.int32)
    got = segment_reduce(*map(torch.from_numpy, (rows, offsets, counts)))
    np.testing.assert_array_equal(got.numpy(), [[7, 46, 0, 19]] * 2)


def test_regroup_rows_by_slot_matches_jax():
    rng = np.random.default_rng(4)
    total = 777
    rows = rng.normal(size=(12, total)).astype(np.float32)
    orig_slot = rng.permutation(total)
    want = np.asarray(jt.regroup_rows_by_slot(
        jnp.asarray(rows), jnp.asarray(orig_slot.astype(np.int32)), total))
    got = tt.regroup_rows_by_slot(torch.from_numpy(rows),
                                  torch.from_numpy(orig_slot))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n, seed, identity", [(300, 2, False),
                                               (1500, 3, False),
                                               (300, 4, True)])
def test_segment_reduce_sorted_matches_jax_regroup(n, seed, identity):
    rows, offsets, counts = _segments(n, seed, max_count=12)
    total = rows.shape[1]
    rng = np.random.default_rng(seed + 10)
    orig_slot = np.arange(total) if identity else rng.permutation(total)
    sorted_rows = np.empty_like(rows)
    sorted_rows[:, np.arange(total)] = rows[:, orig_slot]  # lane i: slot orig_slot[i]
    want = np.asarray(j_segment_reduce(
        jt.regroup_rows_by_slot(jnp.asarray(sorted_rows),
                                jnp.asarray(orig_slot.astype(np.int32)),
                                total),
        jnp.asarray(offsets), jnp.asarray(counts), interpret=True))[:, :n]
    inv = tt.inverse_permutation(torch.from_numpy(orig_slot))
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(inv.numpy()[orig_slot], np.arange(total))
    t_offsets, t_counts = torch.from_numpy(offsets), torch.from_numpy(counts)
    got = segment_reduce_sorted(torch.from_numpy(sorted_rows), inv, t_offsets,
                                t_counts)
    assert got.shape == (12, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # in slot order from 0, as segment_reduce adds the pre-sort rows
    np.testing.assert_array_equal(
        got.numpy(),
        segment_reduce(torch.from_numpy(rows), t_offsets, t_counts).numpy())
