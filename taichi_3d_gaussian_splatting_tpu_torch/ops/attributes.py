"""Per-point screen-space attributes over every pool slot.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/attributes.py``. Invalid and
invisible slots are projected too and masked downstream.
``compute_point_attributes`` is dense torch (the autograd path);
``point_attributes`` computes what the rasterizer's attribute stage needs
of a frame without gradient, and ``point_attributes_vjp`` maps the
cotangents of its uv, conic, opacity and colour back to xyz and the
features without a tape: CUDA tensors go to their kernels in
``csrc/attributes.cu``, CPU tensors to ``point_attributes_plain`` and
autograd of it (``point_attributes_vjp_plain``).

Feature layout:
  feat[0:4]   quaternion xyzw
  feat[4:7]   log scale
  feat[7]     pre-sigmoid opacity
  feat[8:24]  SH coefficients, R channel (band <= 3)
  feat[24:40] SH G
  feat[40:56] SH B
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build
from taichi_3d_gaussian_splatting_tpu_torch.ops import projection as proj
from taichi_3d_gaussian_splatting_tpu_torch.ops.sh import sh_basis
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    inverse_qt,
    quaternion_to_rotation_matrix,
)

# SH band of each of the 16 coefficients.
_COEFF_BAND = (0, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3)


class PointAttributes(NamedTuple):
    """Screen-space attributes, one row per pool slot (all shapes (N, ...))."""

    uv: torch.Tensor           # (N, 2) pixel coords of the projected center
    xyz_cam: torch.Tensor      # (N, 3) camera-frame position (z = depth)
    cov2d: torch.Tensor        # (N, 3) projected covariance (a, b, c), unfiltered
    conic: torch.Tensor        # (N, 4) filtered inverse cov (a, b, c) + rescale
    opacity: torch.Tensor      # (N,)  sigmoid(alpha)
    color: torch.Tensor        # (N, 3) SH color along camera->point ray
    radius: torch.Tensor       # (N,)  conservative splat radius in pixels
    radius_xy: torch.Tensor    # (N, 2) per-axis output-lossless cull radius


def compute_point_attributes(
    xyz: torch.Tensor,            # (N, 3)
    features: torch.Tensor,       # (N, 56)
    q_cam: torch.Tensor,          # (4,) or (N, 4) world->camera rotation, xyzw
    t_cam: torch.Tensor,          # (3,) or (N, 3) world->camera translation
    K: torch.Tensor,              # (3, 3)
    camera_center: torch.Tensor,  # (3,) or (N, 3) camera origin, world frame
    sh_max_band: int = 3,
) -> PointAttributes:
    """Project every pool slot to screen space. ``sh_max_band`` masks the SH
    bands above it. A pose given per point (the JAX package's per-object
    poses, which it maps over points) broadcasts through the same
    elementwise formulas."""
    R_cw = quaternion_to_rotation_matrix(q_cam)

    quat = features[:, 0:4]
    # guarded normalize: zero-padded invalid rows would otherwise give 0/0
    quat = quat / torch.clamp_min(
        torch.linalg.vector_norm(quat, dim=-1, keepdim=True), 1e-12)
    log_scale = features[:, 4:7]
    alpha_logit = features[:, 7]
    sh = features[:, 8:56].reshape(-1, 3, 16)

    uv, xyz_cam = proj.project_point(xyz, R_cw, t_cam, K)
    a, b, c = proj.project_cov2d_components(quat, log_scale, R_cw, K, xyz_cam)
    ca, cb, cc, rescale, radius = proj.conic_rescale_radius_components(a, b, c)
    conic = torch.stack([ca, cb, cc, rescale], dim=-1)
    cov2d = torch.stack([a, b, c], dim=-1)

    opacity = torch.sigmoid(alpha_logit)

    # Per-axis output-lossless cull radius: the blend skips alpha < 1/255,
    # and the axis extent of {q <= qm} of the filtered quadratic is
    # sqrt(qm * Sigma_axis), so tiles beyond it hold only skipped pixels.
    qm = 2.0 * torch.log(torch.clamp_min(255.0 * conic[:, 3] * opacity, 1e-30))
    qm = torch.clamp_min(qm, 0.0)
    af = cov2d[:, 0] + proj.COV2D_FILTER
    cf = cov2d[:, 2] + proj.COV2D_FILTER
    rx = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(af, 0.0)))
    ry = torch.minimum(radius, torch.sqrt(qm * torch.clamp_min(cf, 0.0)))
    radius_xy = torch.stack([rx, ry], dim=-1)

    basis = sh_basis(xyz - camera_center)  # (N, 16)
    band_mask = _sh_band_mask(sh_max_band, basis.dtype, basis.device)
    raw = torch.sum(sh * (basis * band_mask)[:, None, :], dim=-1)
    color = torch.sigmoid(raw)

    return PointAttributes(
        uv=uv, xyz_cam=xyz_cam, cov2d=cov2d, conic=conic,
        opacity=opacity, color=color, radius=radius, radius_xy=radius_xy,
    )


def _sh_band_mask(max_band: int, dtype, device) -> torch.Tensor:
    """(16,) mask keeping coefficients of bands <= max_band: band b holds
    coefficients [b^2, (b + 1)^2) (``_COEFF_BAND``). Made on the device, so
    no host copy (which a CUDA graph could not capture) feeds the step."""
    keep = (int(max_band) + 1) ** 2
    return (torch.arange(len(_COEFF_BAND), device=device) < keep).to(dtype)


def wants_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def point_attributes_plain(xyz, features, q_pc, t_pc, K, sh_max_band=3,
                           row0=0, point_object_id=None):
    """Plain PyTorch version of :func:`point_attributes` (same contract);
    differentiable with respect to xyz, features and the pose."""
    if point_object_id is not None and q_pc.dim() == 2:
        idx = point_object_id.long()
        q, t = q_pc[idx], t_pc[idx]
    else:
        q, t = q_pc.reshape(4), t_pc.reshape(3)
    q_cw, t_cw = inverse_qt(q, t)
    a = compute_point_attributes(xyz, features, q_cw, t_cw, K, t, sh_max_band)
    uv = a.uv
    if row0:
        uv = uv - uv.new_tensor([0.0, float(row0)])
    return (uv, a.cov2d, a.conic, a.opacity, a.color, a.xyz_cam[:, 2],
            a.radius_xy)


def _sh_coeffs(sh_max_band) -> int:
    """The SH coefficients a channel keeps at ``sh_max_band``."""
    return min((int(sh_max_band) + 1) ** 2, len(_COEFF_BAND))


def _kernel_inputs(what, xyz, features, q_pc, t_pc, K, point_object_id):
    """The attribute kernels' input checks: raise ValueError or TypeError
    on what the kernels do not take. Returns (xyz, features, q_pc, t_pc,
    ids), the pose contiguous, ids the int32 object ids where per-object
    poses pick the pose, else None."""
    n = xyz.shape[0]
    cuda_build.require(xyz, "xyz", torch.float32, 2)
    cuda_build.require(features, "features", torch.float32, 2)
    cuda_build.require(K, "K", torch.float32, 2)
    if xyz.shape != (n, 3) or features.shape != (n, 56) or K.shape != (3, 3):
        raise ValueError(f"need xyz (N, 3), features (N, 56), K (3, 3); got "
                         f"{tuple(xyz.shape)}, {tuple(features.shape)}, "
                         f"{tuple(K.shape)}")
    if features.data_ptr() % 16:
        raise ValueError("features: the kernel reads 16-byte aligned rows")
    ids = None
    if point_object_id is not None and q_pc.dim() == 2:
        ids = point_object_id
        cuda_build.require(ids, "point_object_id", torch.int32, 1)
        if (ids.shape != (n,) or q_pc.shape[1] != 4
                or t_pc.shape != (q_pc.shape[0], 3)):
            raise ValueError("per-object poses need q (K, 4), t (K, 3) and "
                             "point_object_id (N,)")
    else:
        q_pc, t_pc = q_pc.reshape(4), t_pc.reshape(3)
    # a pose cut from a (4, 4) matrix is a strided view: copy its few floats
    q_pc, t_pc = q_pc.contiguous(), t_pc.contiguous()
    cuda_build.require(q_pc, "q_pc", torch.float32, q_pc.dim())
    cuda_build.require(t_pc, "t_pc", torch.float32, t_pc.dim())
    args = (features, q_pc, t_pc, K) + (() if ids is None else (ids,))
    if any(a.device != xyz.device for a in args):
        raise ValueError(f"{what}: inputs lie on different devices")
    return xyz, features, q_pc, t_pc, ids


def point_attributes(xyz: torch.Tensor, features: torch.Tensor,
                     q_pc: torch.Tensor, t_pc: torch.Tensor, K: torch.Tensor,
                     sh_max_band: int = 3, row0: int = 0,
                     point_object_id: Optional[torch.Tensor] = None):
    """Every pool slot's blend inputs of the camera pose (q_pc xyzw, t_pc)
    in the world frame, shapes (4,)/(3,), or per-object poses (K, 4)/(K, 3)
    picked by ``point_object_id``: (uv (N, 2) with v less ``row0``, cov2d
    (N, 3), conic (N, 4), opacity (N,), color (N, 3), depth (N,), radius_xy
    (N, 2)), all f32. Takes no gradient: it raises where one is wanted. On a
    card one launch, equal to the plain version bit for bit; the object ids
    are int32 there, and one outside [0, K) gives NaN fields (the plain
    version raises, or wraps a negative id)."""
    if wants_grad(xyz, features, q_pc, t_pc):
        raise ValueError("point_attributes takes no gradient: use "
                         "point_attributes_plain")
    if xyz.device.type == "cpu":
        return point_attributes_plain(xyz, features, q_pc, t_pc, K,
                                      sh_max_band, row0, point_object_id)
    n = xyz.shape[0]
    xyz, features, q_pc, t_pc, ids = _kernel_inputs(
        "point_attributes", xyz, features, q_pc, t_pc, K, point_object_id)
    out = [torch.empty(shape, dtype=torch.float32, device=xyz.device)
           for shape in ((n, 2), (n, 3), (n, 4), (n,), (n, 3), (n,), (n, 2))]
    if n == 0:
        return tuple(out)
    launch = cuda_build.bind("attributes", "point_attributes_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 8)
    err = launch(xyz.data_ptr(), features.data_ptr(), n, q_pc.data_ptr(),
                 t_pc.data_ptr(), None if ids is None else ids.data_ptr(),
                 q_pc.shape[0] if ids is not None else 1, K.data_ptr(),
                 _sh_coeffs(sh_max_band),
                 float(row0), *(o.data_ptr() for o in out),
                 cuda_build.stream_of(xyz))
    point_attributes.launches += 1
    cuda_build.check(err, "point_attributes")
    return tuple(out)


point_attributes.launches = 0


def point_attributes_vjp_plain(xyz, features, q_pc, t_pc, K, sh_max_band=3,
                               row0=0, point_object_id=None, d_uv=None,
                               d_conic=None, d_opacity=None, d_color=None):
    """Plain PyTorch version of :func:`point_attributes_vjp` (same
    contract): autograd of :func:`point_attributes_plain`."""
    x = xyz.detach().requires_grad_(True)
    f = features.detach().requires_grad_(True)
    with torch.enable_grad():
        uv, _, conic, opacity, color, _, _ = point_attributes_plain(
            x, f, q_pc.detach(), t_pc.detach(), K, sh_max_band, row0,
            point_object_id)
        return torch.autograd.grad((uv, conic, opacity, color), (x, f),
                                   (d_uv, d_conic, d_opacity, d_color))


def point_attributes_vjp(xyz: torch.Tensor, features: torch.Tensor,
                         q_pc: torch.Tensor, t_pc: torch.Tensor,
                         K: torch.Tensor, sh_max_band: int = 3,
                         row0: int = 0,
                         point_object_id: Optional[torch.Tensor] = None,
                         d_uv: torch.Tensor = None,
                         d_conic: torch.Tensor = None,
                         d_opacity: torch.Tensor = None,
                         d_color: torch.Tensor = None):
    """The VJP of :func:`point_attributes`' uv, conic, opacity and colour at
    the same inputs: their cotangents d_uv (N, 2), d_conic (N, 4),
    d_opacity (N,) and d_color (N, 3) to (d_xyz (N, 3), d_features (N, 56)),
    f32; the pose takes none. On a card one launch that recomputes each
    point (no tape), equal to autograd of the plain version to f32
    rounding, with autograd's subgradient at every guard; the same bits at
    every launch. ``row0`` moves no gradient. The inputs are checked on
    either device; CPU tensors go to :func:`point_attributes_vjp_plain`."""
    n = xyz.shape[0]
    plain_args = (xyz, features, q_pc, t_pc, K, sh_max_band, row0,
                  point_object_id, d_uv, d_conic, d_opacity, d_color)
    xyz, features, q_pc, t_pc, ids = _kernel_inputs(
        "point_attributes_vjp", xyz, features, q_pc, t_pc, K,
        point_object_id)
    cots = (("d_uv", d_uv, (n, 2)), ("d_conic", d_conic, (n, 4)),
            ("d_opacity", d_opacity, (n,)), ("d_color", d_color, (n, 3)))
    for name, c, shape in cots:
        if c is None:
            raise ValueError(f"point_attributes_vjp: {name} is missing")
        cuda_build.require(c, name, torch.float32, len(shape))
        if c.shape != shape or c.device != xyz.device:
            raise ValueError(f"{name}: need {shape} on {xyz.device}, got "
                             f"{tuple(c.shape)} on {c.device}")
    if xyz.device.type == "cpu":
        return point_attributes_vjp_plain(*plain_args)
    d_xyz = torch.empty((n, 3), dtype=torch.float32, device=xyz.device)
    d_features = torch.empty((n, 56), dtype=torch.float32,
                             device=xyz.device)
    if n == 0:
        return d_xyz, d_features
    launch = cuda_build.bind("attributes", "point_attributes_vjp_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int] + [ctypes.c_void_p] * 7)
    err = launch(xyz.data_ptr(), features.data_ptr(), n, q_pc.data_ptr(),
                 t_pc.data_ptr(), None if ids is None else ids.data_ptr(),
                 q_pc.shape[0] if ids is not None else 1, K.data_ptr(),
                 _sh_coeffs(sh_max_band), d_uv.data_ptr(), d_conic.data_ptr(),
                 d_opacity.data_ptr(), d_color.data_ptr(), d_xyz.data_ptr(),
                 d_features.data_ptr(), cuda_build.stream_of(xyz))
    point_attributes_vjp.launches += 1
    cuda_build.check(err, "point_attributes_vjp")
    return d_xyz, d_features


point_attributes_vjp.launches = 0


def frustum_cull_mask(
    uv: torch.Tensor,
    depth: torch.Tensor,
    invalid_mask: torch.Tensor,
    width: int,
    height: int,
    near: float,
    far: float,
    tile_size: Union[int, Tuple[int, int]],
    boundary_tiles: int = 3,
    boundary_tiles_v: int | None = None,
) -> torch.Tensor:
    """Visibility mask: near < z < far and the projected center inside the
    image padded by ``boundary_tiles`` tiles. The default vertical pad uses
    tile_w for both axes; ``boundary_tiles_v`` overrides it in tile rows."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops.tiling import tile_wh
    tile_w, tile_h = tile_wh(tile_size)
    pad_u = tile_w * boundary_tiles
    pad_v = (tile_w * boundary_tiles if boundary_tiles_v is None
             else tile_h * boundary_tiles_v)
    in_depth = (depth > near) & (depth < far)
    in_u = (uv[:, 0] >= -pad_u) & (uv[:, 0] < width + pad_u)
    in_v = (uv[:, 1] >= -pad_v) & (uv[:, 1] < height + pad_v)
    return in_depth & in_u & in_v & ~invalid_mask
