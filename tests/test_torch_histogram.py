"""The port's bucket histogram (plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode: integer counts, exact."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops.histogram import (  # noqa: E402
    bucket_histogram as jax_histogram,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.histogram import (  # noqa: E402
    bucket_histogram,
)


@pytest.mark.parametrize("n, num_buckets", [
    (0, 4),          # empty input
    (1000, 1),
    (5000, 7),       # not a block multiple
    (4096, 510),     # the full-width frame's tile count
    (3000, 1500),    # more buckets than one chunk of the TPU kernel
])
def test_histogram_matches_jax(n, num_buckets):
    rng = np.random.default_rng(n + num_buckets)
    # ids below 0 and at or above num_buckets must be ignored
    ids = rng.integers(-3, num_buckets + 3, n).astype(np.int32)
    want = np.asarray(jax_histogram(jnp.asarray(ids), num_buckets,
                                    interpret=True))
    got = bucket_histogram(torch.from_numpy(ids), num_buckets)
    assert got.dtype == torch.int32 and got.shape == (num_buckets,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_histogram_of_sorted_tile_ids_gives_ranges():
    ids = np.sort(np.random.default_rng(1).integers(0, 12, 300)).astype(np.int32)
    hist = bucket_histogram(torch.from_numpy(ids), 10).numpy()
    bounds = np.concatenate([[0], np.cumsum(hist)])
    np.testing.assert_array_equal(bounds, np.searchsorted(ids, np.arange(11)))
