"""The port's per-object poses and camera-pose gradients against the JAX
package's rasterizer (Pallas in interpret mode).

Gates are the JAX package's own (tests/test_rasterizer.py): images at rgb
and alpha atol 1e-4, depth atol 5e-4, count exact; gradients at atol 5e-4,
rtol 1e-3. JAX's attribute VJP is NaN at a zero vector (ROADMAP.md C), and
a NaN row makes its pose cotangent, a sum over points, NaN too: the pose
cotangents are compared on scenes without such rows, the per-point
gradients on the rows where JAX is finite.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from tests.test_torch_rasterizer import JCFG, TCFG  # noqa: E402
from tests.torch_port_scenes import make_K, make_scene  # noqa: E402

GATE = dict(atol=5e-4, rtol=1e-3)


def _pose(seed, angle=0.05, shift=0.08):
    """A seeded small camera pose (q xyzw, t) near the identity."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    half = 0.5 * angle * rng.uniform(0.5, 1.0)
    q = np.concatenate([np.sin(half) * axis, [np.cos(half)]])
    return q.astype(np.float32), rng.uniform(-shift, shift, 3).astype(
        np.float32)


def _object_poses(k=3):
    qs, ts = zip(*(_pose(10 + i) for i in range(k)))
    return np.stack(qs), np.stack(ts)


def _cams():
    return (jr.Camera(jnp.asarray(make_K()), 64, 64),
            tr.Camera(torch.from_numpy(make_K()), 64, 64))


def _images(out):
    return tuple(np.asarray(getattr(out, f)) if not isinstance(
        getattr(out, f), torch.Tensor) else getattr(out, f).numpy()
        for f in ("rgb", "depth", "alpha", "count"))


@pytest.mark.parametrize("rgb_only", [False, True])
def test_per_object_poses_match_jax(rgb_only):
    xyz, feats, invalid = make_scene(160, seed=21)
    oid = (np.arange(160) % 3).astype(np.int32)
    q, t = _object_poses(3)
    jcam, tcam = _cams()
    jcfg = dataclasses.replace(JCFG, rgb_only=rgb_only)
    tcfg = dataclasses.replace(TCFG, rgb_only=rgb_only)
    want = _images(jr.rasterize(*map(jnp.asarray, (xyz, feats, invalid, q, t)),
                                jcam, jcfg, point_object_id=jnp.asarray(oid)))
    got = _images(tr.rasterize(*map(torch.from_numpy,
                                    (xyz, feats, invalid, q, t)),
                               tcam, tcfg,
                               point_object_id=torch.from_numpy(oid)))
    assert got[0].max() > 0.1
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    if not rgb_only:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=5e-4)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got[3].astype(np.int32),
                                      want[3].astype(np.int32))


def test_equal_object_poses_are_the_single_pose_bit_for_bit():
    """K equal poses give the single-pose frame: the per-point formulas are
    the single pose's, broadcast."""
    xyz, feats, invalid = make_scene(160, seed=4)
    q, t = _pose(3)
    _, tcam = _cams()
    args = [torch.from_numpy(a) for a in (xyz, feats, invalid)]
    oid = torch.from_numpy((np.arange(160) % 2).astype(np.int32))
    one = tr.rasterize(*args, torch.from_numpy(q), torch.from_numpy(t), tcam,
                       TCFG, point_object_id=oid)
    many = tr.rasterize(*args, torch.from_numpy(np.stack([q, q])),
                        torch.from_numpy(np.stack([t, t])), tcam, TCFG,
                        point_object_id=oid)
    for f in ("rgb", "depth", "alpha", "count"):
        assert torch.equal(getattr(one, f), getattr(many, f)), f


def _pose_grads(xyz, feats, invalid, q, t, oid=None):
    g = np.random.default_rng(8).normal(size=(64, 64, 3)).astype(np.float32)
    jcam, tcam = _cams()
    _, jctx, jvjp = jr.rasterize_fwd_ctx(
        *map(jnp.asarray, (xyz, feats, invalid, q, t)), jcam, JCFG,
        point_object_id=None if oid is None else jnp.asarray(oid),
        with_pose_grads=True)
    want, _ = jr.rasterize_bwd(jctx, jvjp, jnp.asarray(g), jcam, JCFG)
    _, ctx, vjp = tr.rasterize_fwd_ctx(
        *map(torch.from_numpy, (xyz, feats, invalid, q, t)), tcam, TCFG,
        point_object_id=None if oid is None else torch.from_numpy(oid),
        with_pose_grads=True)
    got, _ = tr.rasterize_bwd(ctx, vjp, torch.from_numpy(g), tcam, TCFG)
    return [a.numpy() for a in got], [np.asarray(a) for a in want]


@pytest.mark.parametrize("per_object", [False, True])
def test_pose_cotangents_match_jax(per_object):
    xyz, feats, _ = make_scene(160, seed=17)
    invalid = np.zeros(160, bool)  # no zero rows: JAX's sum stays finite
    if per_object:
        q, t = _object_poses(2)
        oid = (np.arange(160) % 2).astype(np.int32)
    else:
        (q, t), oid = _pose(5), None
    got, want = _pose_grads(xyz, feats, invalid, q, t, oid)
    assert len(got) == len(want) == 4
    d_q, d_t = got[2], got[3]
    assert d_q.shape == q.shape and d_t.shape == t.shape
    assert np.isfinite(want[2]).all() and np.isfinite(want[3]).all()
    assert np.abs(d_q).max() > 1e-3 and np.abs(d_t).max() > 1e-3
    np.testing.assert_allclose(d_q, want[2], **GATE)
    np.testing.assert_allclose(d_t, want[3], **GATE)
    for i in (0, 1):
        ok = np.isfinite(want[i]).all(1)
        np.testing.assert_allclose(got[i][ok], want[i][ok], **GATE)


def test_pose_cotangents_are_finite_over_invalid_rows():
    """A zero-padded slot (zero quaternion) makes JAX's pose cotangent NaN;
    the port's stays finite, with the per-point rows matching JAX's where
    JAX is finite."""
    xyz, feats, invalid = make_scene(160, seed=17)
    xyz[-4:] = 0.0
    feats[-4:] = 0.0
    invalid[-4:] = True
    got, want = _pose_grads(xyz, feats, invalid, *_pose(5))
    assert np.isfinite(got[2]).all() and np.isfinite(got[3]).all()
    for i in (0, 1):
        ok = np.isfinite(want[i]).all(1)
        assert ok.sum() >= 150
        np.testing.assert_allclose(got[i][ok], want[i][ok], **GATE)


def test_rasterize_differentiates_the_pose():
    """q and t that require grad get the pose cotangent through autograd
    (the blend's backward kernels, then the attributes' graph); it equals
    the explicit pair's."""
    xyz, feats, invalid = make_scene(160, seed=2)
    q, t = _pose(9)
    _, tcam = _cams()
    g = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 64, 3)).astype(np.float32))
    qt = torch.from_numpy(q).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    args = [torch.from_numpy(a) for a in (xyz, feats, invalid)]
    out = tr.rasterize(*args, qt, tt, tcam, TCFG)
    d_q, d_t = torch.autograd.grad((out.rgb * g).sum(), (qt, tt))
    _, ctx, vjp = tr.rasterize_fwd_ctx(*args, torch.from_numpy(q),
                                       torch.from_numpy(t), tcam, TCFG,
                                       with_pose_grads=True)
    want, _ = tr.rasterize_bwd(ctx, vjp, g, tcam, TCFG)
    np.testing.assert_allclose(d_q.numpy(), want[2].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), want[3].numpy(), rtol=1e-5,
                               atol=1e-6)
