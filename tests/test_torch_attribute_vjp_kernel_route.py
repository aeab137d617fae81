"""The attribute VJP's CPU route: ``point_attributes_vjp`` on CPU tensors
is autograd of ``compute_raw_attrs`` bit for bit, its input checks raise
before any launch, and ``rasterize_fwd_ctx`` keeps autograd's tape on the
CPU (the card's kernel pair is held to these by
``tests/test_torch_kernels_cuda.py``). 64x64 pools of 160-200 points; no
JAX."""
import numpy as np
import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as attrs
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as tr
from tests.torch_port_scenes import make_K, make_odd_scene, make_scene

POSE = (np.asarray([0.05, -0.02, 0.01, 1.0], np.float32)
        / np.float32(np.linalg.norm([0.05, -0.02, 0.01, 1.0])),
        np.asarray([0.1, 0.0, -0.3], np.float32))
OBJECT_POSES = (
    np.asarray([POSE[0], [0.0, 0.0, 0.0, 1.0], [0.0, 0.0998, 0.0, 0.995]],
               np.float32),
    np.asarray([POSE[1], [0.0, 0.0, 0.0], [0.2, -0.1, 0.05]], np.float32))


def _inputs(objects, seed=0):
    xyz, feats, _ = make_odd_scene()
    n = len(xyz)
    if objects:
        q, t = map(torch.from_numpy, OBJECT_POSES)
        ids = torch.from_numpy(np.random.default_rng(5).integers(
            0, 3, n).astype(np.int32))
    else:
        (q, t), ids = map(torch.from_numpy, POSE), None
    rng = np.random.default_rng(seed)
    cots = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((n, 2), (n, 4), (n,), (n, 3))]
    return torch.from_numpy(xyz), torch.from_numpy(feats), q, t, ids, cots


@pytest.mark.parametrize("objects", [False, True])
@pytest.mark.parametrize("band, row0", [(3, 0), (1, 40)])
def test_vjp_on_cpu_is_autograd_of_compute_raw_attrs(objects, band, row0):
    """The wrapper's CPU route (the plain version) equals torch autograd
    through ``compute_raw_attrs`` bit for bit on the odd pool (zero rows,
    points behind the camera, at its centre and on its plane), finite on
    every row, and never launches."""
    xyz, feats, q, t, ids, cots = _inputs(objects)
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64, row0)
    before = attrs.point_attributes_vjp.launches
    got = attrs.point_attributes_vjp(xyz, feats, q, t, cam.K, band, row0,
                                     ids, *cots)
    assert attrs.point_attributes_vjp.launches == before
    x = xyz.clone().requires_grad_(True)
    f = feats.clone().requires_grad_(True)
    raw, _ = tr.compute_raw_attrs(x, f, q, t, cam, band, ids)
    want = torch.autograd.grad((raw.uv, raw.conic, raw.opacity, raw.color),
                               (x, f), tuple(cots))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool(torch.isfinite(g).all())
    keep = (band + 1) ** 2
    sh = got[1][:, 8:].reshape(-1, 3, 16)
    assert not bool(sh[:, :, keep:].any()) and bool(sh[:, :, :keep].any())


def _bad(case, xyz, feats, q, t, ids, cots):
    """The inputs of one malformed call."""
    d_uv, d_conic, d_opacity, d_color = cots
    if case == "xyz_shape":
        xyz = xyz[:, :2].contiguous()
    elif case == "features_shape":
        feats = feats[:, :48].contiguous()
    elif case == "missing_cotangent":
        d_color = None
    elif case == "cotangent_shape":
        d_conic = d_conic[:, :3].contiguous()
    elif case == "cotangent_rows":
        d_uv = d_uv[1:]
    elif case == "object_poses":
        q, t = torch.from_numpy(OBJECT_POSES[0]), torch.zeros((2, 3))
        ids = torch.zeros((len(xyz),), dtype=torch.int32)
    elif case == "cotangent_strided":
        d_color = d_color.t().contiguous().t()
    return xyz, feats, q, t, ids, [d_uv, d_conic, d_opacity, d_color]


@pytest.mark.parametrize("case", [
    "xyz_shape", "features_shape", "missing_cotangent", "cotangent_shape",
    "cotangent_rows", "object_poses", "cotangent_strided"])
def test_vjp_checks_its_inputs_before_any_launch(case):
    """A malformed call raises ValueError, on the CPU as on a card, and
    launches nothing."""
    args = _bad(case, *_inputs(False))
    xyz, feats, q, t, ids, cots = args
    before = attrs.point_attributes_vjp.launches
    with pytest.raises(ValueError):
        attrs.point_attributes_vjp(xyz, feats, q, t,
                                   torch.from_numpy(make_K()), 3, 0, ids,
                                   *cots)
    assert attrs.point_attributes_vjp.launches == before


@pytest.mark.parametrize("pose_grads", [False, True])
def test_rasterize_fwd_ctx_keeps_the_tape_on_the_cpu(pose_grads):
    """On the CPU the forward records autograd's tape of the attributes
    (saved tensors) with and without pose gradients and launches no
    attribute kernel; its ``attrs_vjp`` of the blend's cotangents is the
    plain VJP bit for bit (and the pose's too with ``with_pose_grads``)."""
    xyz, feats, invalid = map(torch.from_numpy, make_scene(200, 7))
    cam = tr.Camera(torch.from_numpy(make_K()), 64, 64)
    cfg = tr.RasterizerConfig(tile_size=32)
    q, t = map(torch.from_numpy, POSE)
    saved = []
    before = (attrs.point_attributes.launches,
              attrs.point_attributes_vjp.launches)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x) or x, lambda x: x):
        out, ctx, vjp = tr.rasterize_fwd_ctx(xyz, feats, invalid, q, t, cam,
                                             cfg, with_pose_grads=pose_grads)
    assert len(saved) > 100
    tile = (32, 32)
    d_rgb = tr._image_to_tiles(torch.ones_like(out.rgb), 2, 2, tile)
    d_raw, _ = tr._blend_bwd_impl(ctx.raw, ctx.keys, ctx.table,
                                  ctx.out_tiles, d_rgb, tile, (2, 2), cfg)
    grads = vjp(d_raw)
    assert len(grads) == (4 if pose_grads else 2)
    assert before == (attrs.point_attributes.launches,
                      attrs.point_attributes_vjp.launches)
    plain = attrs.point_attributes_vjp_plain(
        xyz, feats, q, t, cam.K, 3, 0, None, d_raw.uv, d_raw.conic,
        d_raw.opacity, d_raw.color)
    for g, w in zip(grads[:2], plain):
        assert torch.equal(g, w)
        assert float(g.abs().max()) > 0
    if pose_grads:
        assert all(bool(torch.isfinite(g).all()) for g in grads[2:])
