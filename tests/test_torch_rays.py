"""The port's ray helpers (``ops/rays.py``) against the JAX package's and
the numpy oracle of tests/test_rays_pose.py.

Gates: hit flags equal to JAX's everywhere and to the oracle's away from
grazing rays (|discriminant| >= 1e-3, where f32 and f64 may disagree);
points at atol 1e-5 of JAX's (the same f32 algebra; products of order 10
summed in another order) and 2e-3 of the oracle's (tests/test_rays_pose.py);
rays at atol 1e-6 of JAX's and reprojecting to their pixel centres at
1e-3.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rays as jrays  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rays as trays  # noqa: E402
from tests.test_rays_pose import np_disc_margin, np_ray_ellipsoid  # noqa: E402


def _cases(n=1000, seed=11):
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.normal(0, 1, (n, 3)).astype(np.float32)
    S = rng.uniform(0.2, 2.0, (n, 3)).astype(np.float32)
    R = Rotation.random(n, random_state=1).as_matrix().astype(np.float32)
    return o, d, R, t, S


def test_ray_ellipsoid_matches_jax_and_oracle():
    o, d, R, t, S = _cases()
    hit, point = trays.intersect_ray_with_ellipsoid(
        *map(torch.from_numpy, (o, d, R, t, S)))
    jhit, jpoint = jrays.intersect_ray_with_ellipsoid(
        *map(jnp.asarray, (o, d, R, t, S)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(point.numpy(), np.asarray(jpoint), atol=1e-5,
                               rtol=0)
    hits = 0
    for i in range(len(o)):
        if abs(np_disc_margin(o[i], d[i], R[i], t[i], S[i])) < 1e-3:
            continue
        want_hit, want_pt = np_ray_ellipsoid(
            *(a[i].astype(np.float64) for a in (o, d, R, t, S)))
        assert bool(hit[i]) == want_hit, i
        if want_hit:
            hits += 1
            np.testing.assert_allclose(point[i].numpy(), want_pt, atol=2e-3)
        else:
            assert float(point[i].abs().max()) == 0.0
    assert hits > 30


@pytest.mark.parametrize("o, want", [
    ([0.0, 0.0, -5.0], [0.0, 0.0, -1.0]),    # through the centre
    ([0.0, 0.0, 0.0], [0.0, 0.0, 1.0]),      # from inside: the far root
    ([3.0, 0.0, -5.0], None),                # a miss
])
def test_ray_ellipsoid_cases(o, want):
    hit, p = trays.intersect_ray_with_ellipsoid(
        torch.tensor(o), torch.tensor([0.0, 0.0, 1.0]), torch.eye(3),
        torch.zeros(3), torch.ones(3))
    assert bool(hit) == (want is not None)
    np.testing.assert_allclose(p.numpy(), want or [0.0, 0.0, 0.0], atol=1e-5)


def test_ray_gaussian_matches_jax():
    o, d, _, t, _ = _cases(200, seed=3)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(200, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ls = rng.uniform(-1.5, 0.5, (200, 3)).astype(np.float32)
    hit, point = trays.intersect_ray_with_gaussian(
        *map(torch.from_numpy, (o, d, q, ls, t)))
    jhit, jpoint = jrays.intersect_ray_with_gaussian(
        *map(jnp.asarray, (o, d, q, ls, t)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0 < int(hit.sum()) < 200
    np.testing.assert_allclose(point.numpy(), np.asarray(jpoint), atol=1e-5,
                               rtol=0)


def test_ray_from_pixel_matches_jax_and_reprojects():
    K = np.asarray([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]], np.float32)
    R_cw = Rotation.random(random_state=2).as_matrix().astype(np.float32)
    t_cw = np.asarray([0.3, -0.2, 0.5], np.float32)
    T_cw = np.eye(4, dtype=np.float32)
    T_cw[:3, :3], T_cw[:3, 3] = R_cw, t_cw
    ys, xs = np.mgrid[0:64:8, 0:64:8]
    uv = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    origin, direction = trays.ray_from_pixel(*map(torch.from_numpy,
                                                  (uv, K, T_cw)))
    jo, jd = jrays.ray_from_pixel(*map(jnp.asarray, (uv, K, T_cw)))
    np.testing.assert_allclose(origin.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(direction.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(
        np.linalg.norm(direction.numpy(), axis=-1), 1.0, atol=1e-6)
    pts = origin.numpy() + 3.7 * direction.numpy()
    cam = (R_cw @ pts.T).T + t_cw
    proj = (K @ cam.T).T
    np.testing.assert_allclose(proj[:, :2] / proj[:, 2:3], uv + 0.5,
                               atol=1e-3)
    # integer pixel coordinates give the same rays
    o2, d2 = trays.ray_from_pixel(torch.from_numpy(uv.astype(np.int64)),
                                  torch.from_numpy(K), torch.from_numpy(T_cw))
    assert torch.equal(d2, direction) and torch.equal(o2, origin)
