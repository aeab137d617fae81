"""The port's attribute math against the JAX package: transforms, SH,
projection, per-point attributes and the frustum cull.

Same numpy inputs through both; float32 with a different operation order,
so values agree to rtol 1e-5 / atol 1e-5 (NaN where JAX has NaN); the cull
mask is exact. The inputs hold zero (invalid) rows, points behind the
camera, at the camera centre and on the camera plane.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from taichi_3d_gaussian_splatting_tpu.ops import attributes as ja  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import projection as jp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import rasterizer as jr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import sh as jsh  # noqa: E402
from taichi_3d_gaussian_splatting_tpu.ops import transforms as jt  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as ta  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import projection as tp  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import sh as tsh  # noqa: E402
from taichi_3d_gaussian_splatting_tpu_torch.ops import transforms as tt  # noqa: E402
from tests.torch_port_scenes import make_K, make_odd_scene  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5, equal_nan=True)
RNG = np.random.default_rng(11)


def _unit_quats(n):
    q = RNG.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _compare(a, b, **tol):
    """Compare a (possibly nested) JAX result with the port's."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _compare(x, y, **tol)
        return
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **(TOL | tol))


def _run_both(jax_fn, torch_fn, *args):
    a = jax_fn(*[jnp.asarray(x) for x in args])
    b = torch_fn(*[torch.from_numpy(np.array(x)) for x in args])
    _compare(a, b)


Q = _unit_quats(64)
ROT = np.array(jt.quaternion_to_rotation_matrix(jnp.asarray(Q)))
T4 = np.array(jt.se3_from_qt(jnp.asarray(Q), jnp.asarray(
    RNG.normal(size=(64, 3)).astype(np.float32))))
OMEGA = np.concatenate([RNG.normal(size=(63, 3)) * 0.3, np.zeros((1, 3))]
                       ).astype(np.float32)
VEC = RNG.normal(size=(64, 3)).astype(np.float32)

TRANSFORM_CASES = {
    "quaternion_to_rotation_matrix": (Q,),
    "rotation_matrix_to_quaternion": (ROT,),
    "quaternion_multiply": (Q, _unit_quats(64)),
    "quaternion_conjugate": (Q,),
    "quaternion_exp": (OMEGA,),
    "apply_pose_delta": (Q[0], VEC[0], np.concatenate([OMEGA[1], VEC[2]])),
    "quaternion_rotate": (Q, VEC),
    "se3_from_qt": (Q, VEC),
    "inverse_se3": (T4,),
    "inverse_qt": (Q, VEC),
    "se3_to_qt": (T4,),
}


@pytest.mark.parametrize("name", sorted(TRANSFORM_CASES))
def test_transforms_match_jax(name):
    _run_both(getattr(jt, name), getattr(tt, name), *TRANSFORM_CASES[name])


def test_sh_basis_matches_jax():
    d = np.concatenate([VEC, np.zeros((1, 3), np.float32)])  # incl. zero dir
    _run_both(jsh.sh_basis, tsh.sh_basis, d)


def _camera_inputs():
    q_cw = _unit_quats(1)[0] * 0.1 + np.asarray([0, 0, 0, 1], np.float32)
    q_cw /= np.linalg.norm(q_cw)
    t_cw = np.asarray([0.1, -0.2, 0.3], np.float32)
    return q_cw.astype(np.float32), t_cw, make_K()


def test_projection_matches_jax():
    xyz, feats, _ = make_odd_scene()
    q_cw, t_cw, K = _camera_inputs()
    R = np.array(jt.quaternion_to_rotation_matrix(jnp.asarray(q_cw)))
    uv_j, cam_j = jp.project_point(*map(jnp.asarray, (xyz, R, t_cw, K)))
    uv_t, cam_t = tp.project_point(*map(torch.from_numpy, (xyz, R, t_cw, K)))
    _compare((uv_j, cam_j), (uv_t, cam_t))
    quat = feats[:, 0:4] / np.maximum(
        np.linalg.norm(feats[:, 0:4], axis=1, keepdims=True), 1e-12)
    args = (quat, feats[:, 4:7], R, K, np.array(cam_j))
    abc_j = jp.project_cov2d_components(*map(jnp.asarray, args))
    abc_t = tp.project_cov2d_components(*map(torch.from_numpy, args))
    _compare(abc_j, abc_t)
    # conic/rescale/radius, with the clamp range and degenerate rows hit
    abc = [np.array(x) for x in abc_j]
    abc[0][:3], abc[1][:3], abc[2][:3] = 1e30, 0.0, 1e30
    abc[0][3:5], abc[1][3:5], abc[2][3:5] = 0.0, 0.0, 0.0
    _run_both(jp.conic_rescale_radius_components,
              tp.conic_rescale_radius_components, *abc)


@pytest.mark.parametrize("sh_max_band", [0, 3])
def test_point_attributes_match_jax(sh_max_band):
    xyz, feats, _ = make_odd_scene()
    q_cw, t_cw, K = _camera_inputs()
    centre = np.asarray([0.05, 0.1, -0.2], np.float32)
    args = (xyz, feats, q_cw, t_cw, K, centre)
    a_j = ja.compute_point_attributes(*map(jnp.asarray, args),
                                      sh_max_band=sh_max_band)
    a_t = ta.compute_point_attributes(*map(torch.from_numpy, args),
                                      sh_max_band=sh_max_band)
    assert a_t._fields == a_j._fields
    for field in a_j._fields:
        _compare(getattr(a_j, field), getattr(a_t, field))


@pytest.mark.parametrize("tile, pad_v", [(32, None), ((32, 16), 2)])
def test_frustum_cull_mask_matches_jax(tile, pad_v):
    xyz, feats, invalid = make_odd_scene()
    K = make_K()
    q = np.asarray([0, 0, 0, 1], np.float32)
    t = np.zeros(3, np.float32)
    raw, _ = jr.compute_raw_attrs(jnp.asarray(xyz), jnp.asarray(feats),
                                  jnp.asarray(q), jnp.asarray(t),
                                  jr.Camera(jnp.asarray(K), 64, 64))
    uv, depth = np.array(raw.uv), np.array(raw.depth)
    # spread the centres past the padded image edges
    uv = uv * 3.0 - 64.0
    args = (uv, depth, invalid)
    m_j = ja.frustum_cull_mask(*map(jnp.asarray, args), 64, 64, 0.8, 1000.0,
                               tile, boundary_tiles_v=pad_v)
    m_t = ta.frustum_cull_mask(*map(torch.from_numpy, args), 64, 64, 0.8,
                               1000.0, tile, boundary_tiles_v=pad_v)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < m_t.sum() < len(m_t)


def test_compute_raw_attrs_matches_jax():
    xyz, feats, _ = make_odd_scene()
    q_pc = np.asarray([0.05, -0.02, 0.01, 1.0], np.float32)
    q_pc /= np.linalg.norm(q_pc)
    t_pc = np.asarray([0.1, 0.0, -0.3], np.float32)
    K = make_K()
    raw_j, rad_j = jr.compute_raw_attrs(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(q_pc),
        jnp.asarray(t_pc), jr.Camera(jnp.asarray(K), 64, 64))
    raw_t, rad_t = tr.compute_raw_attrs(
        torch.from_numpy(xyz), torch.from_numpy(feats),
        torch.from_numpy(q_pc), torch.from_numpy(t_pc),
        tr.Camera(torch.from_numpy(K), 64, 64))
    assert raw_t._fields == raw_j._fields
    _compare(tuple(raw_j) + (rad_j,), tuple(raw_t) + (rad_t,))
