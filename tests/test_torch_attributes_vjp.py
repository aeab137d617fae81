"""The VJP half of the port's attribute math: torch autograd through
``compute_raw_attrs`` against ``jax.vjp`` of the JAX package's, for a
seeded cotangent on every raw field.

float32 with another operation order: rtol 1e-4, atol 1e-5. The pools hold
invalid rows; the odd pool also zero-padded rows, points behind the camera,
one at the camera centre and one on the camera plane. There JAX's VJP is
NaN on the zero rows and on the point at the camera centre (its norm VJP at
a zero vector gives 0 * inf); the port's is finite everywhere, and the two
are compared on the rows where JAX is finite.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.torch_port_scenes import make_K, make_odd_scene, make_scene  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
POSE = (np.asarray([0.05, -0.02, 0.01, 1.0], np.float32)
        / np.linalg.norm([0.05, -0.02, 0.01, 1.0]).astype(np.float32),
        np.asarray([0.1, 0.0, -0.3], np.float32))
IDENTITY = (np.asarray([0.0, 0.0, 0.0, 1.0], np.float32),
            np.zeros((3,), np.float32))


def _jax_vjp(xyz, feats, ct, pose=POSE):
    q, t = (jnp.asarray(a) for a in pose)
    cam = jr.Camera(jnp.asarray(make_K()), 64, 64)

    def f(x, fe):
        return jr.compute_raw_attrs(x, fe, q, t, cam)[0]

    _, vjp = jax.vjp(f, jnp.asarray(xyz), jnp.asarray(feats))
    return [np.asarray(a) for a in vjp(jr.RawAttrs(*map(jnp.asarray, ct)))]


def _torch_vjp(xyz, feats, ct, pose=POSE):
    x = torch.from_numpy(xyz).requires_grad_(True)
    f = torch.from_numpy(feats).requires_grad_(True)
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    raw, _ = tr.compute_raw_attrs(x, f, *map(torch.from_numpy, pose), cam)
    grads = torch.autograd.grad(tuple(raw), (x, f),
                                tuple(map(torch.from_numpy, ct)))
    return [g.numpy() for g in grads]


def _cotangent(n, seed=0, zero_rows=None):
    rng = np.random.default_rng(seed)
    shapes = [(n, 2), (n, 3), (n, 4), (n,), (n, 3), (n,)]  # RawAttrs order
    ct = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if zero_rows is not None:
        for a in ct:
            a[zero_rows] = 0.0
    return ct


@pytest.mark.parametrize("pool, pose", [
    ("make_scene", POSE), ("odd", POSE), ("odd", IDENTITY)])
def test_attribute_vjp_matches_jax(pool, pose):
    xyz, feats, invalid = make_scene(160, 3) if pool == "make_scene" \
        else make_odd_scene()
    ct = _cotangent(len(xyz))
    want = _jax_vjp(xyz, feats, ct, pose)
    got = _torch_vjp(xyz, feats, ct, pose)
    jax_ok = np.isfinite(want[0]).all(1) & np.isfinite(want[1]).all(1)
    n = len(xyz)
    if pool == "make_scene":
        assert jax_ok.all() and invalid.any()
    elif pose is POSE:
        # the zero-padded rows (zero quaternion)
        assert set(np.flatnonzero(~jax_ok)) == {n - 4, n - 3, n - 2, n - 1}
    else:
        # ... and the point at the camera centre (zero view direction)
        assert set(np.flatnonzero(~jax_ok)) == {n // 10, n - 4, n - 3,
                                                 n - 2, n - 1}
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[jax_ok], w[jax_ok], **TOL)
    assert float(np.abs(got[1][:, 8]).max()) > 0  # the DC colour flows


def test_zero_cotangent_rows_get_zero_gradient():
    """Training gives the invalid and culled rows a zero cotangent: their
    gradients are exactly zero, where JAX's are NaN on the zero rows."""
    xyz, feats, invalid = make_odd_scene()
    ct = _cotangent(len(xyz), seed=1, zero_rows=invalid)
    gx, gf = _torch_vjp(xyz, feats, ct)
    assert np.isfinite(gx).all() and np.isfinite(gf).all()
    assert not gx[invalid].any() and not gf[invalid].any()
    wx, wf = _jax_vjp(xyz, feats, ct)
    assert not np.isfinite(wf[invalid]).all()
    ok = np.isfinite(wx).all(1) & np.isfinite(wf).all(1)
    np.testing.assert_allclose(gx[ok], wx[ok], **TOL)
    np.testing.assert_allclose(gf[ok], wf[ok], **TOL)
