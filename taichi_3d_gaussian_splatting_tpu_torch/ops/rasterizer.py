"""The differentiable tile rasterizer: attributes -> tile keys -> blend ->
image, and its backward.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/rasterizer.py``:

  compute_raw_attrs (projection, EWA, SH, sigmoid: without gradient the
     point-attributes kernel, under autograd plain torch)
  -> build_keys (no gradient: frustum cull, tile bbox, the slot-keys
     kernel, one stable key sort, the sorted-table kernel, the
     tile_ranges kernel for the tile ranges)
  -> blend_forward kernel -> _assemble (tiles -> image)
  backward: blend_backward kernel -> the segment_reduce kernel, which
     reads the sorted per-key rows through the inverse key permutation ->
     per-point raw-attribute gradients -> xyz, features: the
     attribute-VJP kernel (``rasterize_fwd_ctx`` on a card), else torch
     autograd of compute_raw_attrs.

``rasterize`` differentiates through ``_BlendCore`` (a
``torch.autograd.Function``) when xyz, features or the camera pose (q, t)
require grad, and runs under ``torch.no_grad()`` otherwise, so rendering
builds no graph. ``rasterize_fwd_ctx`` / ``rasterize_bwd`` are the
trainer's explicit pair, which also returns the densification statistics
(``GradStats``) and, ``with_pose_grads``, the pose cotangents. The pose is
one (4,)/(3,) camera pose, or (K, 4)/(K, 3) per-object poses picked per
point by ``point_object_id``.

Gradient semantics, as the JAX package's: only the rgb output
backpropagates; the 0.99 alpha clamp is straight-through; the conic
gradients are exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import blend
from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling
from taichi_3d_gaussian_splatting_tpu_torch.ops.attributes import (
    frustum_cull_mask,
    point_attributes,
    point_attributes_plain,
    point_attributes_vjp,
    wants_grad,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.packing import round_bf16
from taichi_3d_gaussian_splatting_tpu_torch.ops.segment_reduce import (
    segment_reduce_sorted,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.stages import stage


@dataclass(frozen=True)
class RasterizerConfig:
    """The JAX package's RasterizerConfig, field for field.

    ``key_cap`` here is the JAX package's default; the port reads no
    capacity from the config. A capacity is passed as ``key_cap=`` to
    ``rasterize`` (the renderer's graph frame, ``apps/render.py``, at a
    capacity fitted to its poses) and ``rasterize_fwd_ctx`` (the windowed
    train step, ``trainer.make_train_step`` with ``scan_steps``, and the
    trainer's ``steps_per_dispatch`` windows, which start from it and refit
    it): the key buffers are (key_cap,) and the keys past it are dropped,
    as the JAX package drops them. Without it a path sizes its key buffer
    to the frame's exact total (the single step, the viewer, the band
    render, validation). ``blend_chunk``,
    ``blend_strips``, ``candidate_mode``, ``cand_scale`` and ``interpret``
    size or steer the TPU kernels; they are accepted so that one config
    serves both packages, and ignored here.
    ``pack_sort_colors`` with ``rgb_only`` rounds the blend table's r and g
    to bf16, as the JAX package's sort carrier does; without ``rgb_only`` it
    is ignored, as there."""

    near_plane: float = 0.8
    far_plane: float = 1000.0
    depth_to_sort_key_scale: float = 100.0
    rgb_only: bool = False
    grad_color_factor: float = 5.0
    grad_high_order_color_factor: float = 1.0
    grad_s_factor: float = 0.5
    grad_q_factor: float = 1.0
    grad_alpha_factor: float = 20.0
    tile_size: int = 32          # tile width in pixels
    tile_h: Optional[int] = None # tile height; None = square
    key_cap: int = 2 ** 21
    extra_info: bool = True
    slim: bool = False           # training fast path: blend rgb only
    exact_tile_cull: bool = True # retire (point, tile) pairs whose max
                                 # in-tile alpha < 1/255 (same output,
                                 # shorter blend ranges)
    blend_chunk: int = 128
    blend_strips: int = 1
    candidate_mode: str = "partition"
    cand_scale: int = 1
    pack_sort_colors: bool = False
    interpret: bool = False
    cull_pad_v_tiles: Optional[int] = None  # vertical cull pad override

    def __post_init__(self):
        if self.slim and self.rgb_only:
            raise ValueError(
                "slim is the training fast path (keeps backward payloads); "
                "rgb_only is the inference fast path — pick one")
        if self.tile_h is not None and self.tile_size % self.tile_h != 0:
            raise ValueError(
                f"tile_h={self.tile_h} must divide tile_size={self.tile_size}")


class Camera(NamedTuple):
    """Pinhole camera. Frame: x right, y down, z forward. ``row0`` > 0
    makes it a band of a taller image: its first row is image row
    ``row0``, and the projected v is taken relative to it (the full
    image's v less row0, one f32 subtraction, exact for the points whose
    centre lies in the band), so a band's pixels see the splats as the
    full image's do."""

    K: torch.Tensor       # (3, 3) intrinsics
    width: int
    height: int
    row0: int = 0


class RasterizeOutput(NamedTuple):
    rgb: torch.Tensor     # (H, W, 3)
    depth: torch.Tensor   # (H, W) alpha-weighted normalized depth
    alpha: torch.Tensor   # (H, W) accumulated opacity (1 - T_final)
    count: torch.Tensor   # (H, W) number of blended splats per pixel


class RawAttrs(NamedTuple):
    """Inputs of the blend, all f32, dense over the N pool slots."""

    uv: torch.Tensor       # (N, 2)
    cov2d: torch.Tensor    # (N, 3) unfiltered (a, b, c)
    conic: torch.Tensor    # (N, 4) filtered inverse + rescale
    opacity: torch.Tensor  # (N,)
    color: torch.Tensor    # (N, 3)
    depth: torch.Tensor    # (N,)


class GradStats(NamedTuple):
    """Densification statistics of the backward pass, dense over pool
    slots."""

    grad_uv: torch.Tensor                   # (N, 2) viewspace position grad
    magnitude_grad_viewspace: torch.Tensor  # (N,) sum over pixels of |grad_uv|
    num_affected_pixels: torch.Tensor       # (N,)
    num_overlap_tiles: torch.Tensor         # (N,) int32
    in_camera: torch.Tensor                 # (N,) bool visibility this frame
    magnitude_grad_viewspace_on_image: torch.Tensor  # (H, W, 2); (1, 1, 2)
                                                     # zeros when slim


class RenderContext(NamedTuple):
    """What ``rasterize_bwd`` needs of the forward (all without grad)."""

    raw: RawAttrs
    keys: tiling.TileKeys
    table: torch.Tensor
    out_tiles: torch.Tensor
    visible: torch.Tensor


def _cfg_tile(cfg: RasterizerConfig) -> tuple:
    """(tile_w, tile_h) of a config (tile_h=None means square)."""
    th = cfg.tile_size if cfg.tile_h is None else cfg.tile_h
    return (cfg.tile_size, th)


def pin_f32_matmul() -> None:
    """Keep f32 matmuls and convolutions in full f32 (no TF32). The render
    path has no matmul of its own; the plain versions and the tests use
    them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _tiles_to_image(tiles: torch.Tensor, tiles_x: int, tiles_y: int, tile):
    """(num_tiles, tile_w*tile_h, C) -> (H, W, C)."""
    tw, th = tiling.tile_wh(tile)
    c = tiles.shape[-1]
    img = tiles.reshape(tiles_y, tiles_x, th, tw, c)
    return img.permute(0, 2, 1, 3, 4).reshape(tiles_y * th, tiles_x * tw, c)


def _image_to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int, tile):
    """(H, W, C) -> (num_tiles, tile_w*tile_h, C)."""
    tw, th = tiling.tile_wh(tile)
    c = img.shape[-1]
    t = img.reshape(tiles_y, th, tiles_x, tw, c)
    return t.permute(0, 2, 1, 3, 4).reshape(tiles_y * tiles_x, th * tw, c)


def _check_size(camera: Camera, tile) -> None:
    if camera.width % tile[0] or camera.height % tile[1]:
        raise ValueError(f"image {camera.width}x{camera.height} is not a "
                         f"multiple of the {tile[0]}x{tile[1]} tile")


def compute_raw_attrs(xyz, features, q_pointcloud_camera, t_pointcloud_camera,
                      camera: Camera, sh_max_band=3,
                      point_object_id: Optional[torch.Tensor] = None):
    """Project pool slots to screen space. ``q/t_pointcloud_camera`` is the
    camera pose in the world frame, shapes (4,)/(3,), or per-object poses
    (K, 4)/(K, 3), each point taking the pose of its ``point_object_id``.
    Returns (RawAttrs, per-axis cull radius (N, 2)). Where a gradient is
    wanted (grad mode on and xyz, features or the pose requiring grad) the
    plain version builds autograd's graph; otherwise ``point_attributes``
    runs, one kernel launch on a card."""
    fn = (point_attributes_plain
          if wants_grad(xyz, features, q_pointcloud_camera,
                        t_pointcloud_camera) else point_attributes)
    *fields, radius_xy = fn(xyz, features, q_pointcloud_camera,
                            t_pointcloud_camera, camera.K, sh_max_band,
                            camera.row0, point_object_id)
    return RawAttrs(*fields), radius_xy


def attr_columns(raw: RawAttrs, pack_colors: bool = False) -> torch.Tensor:
    """(10, N) blend columns [u, v, conic a, b, c, log(rescale*opacity), r, g,
    b, depth]. Rescale and opacity are sanitized BEFORE the log, so NaN
    features blend as fully transparent (log(1e-37) = -85). With
    ``pack_colors`` r and g are rounded to bf16 (the values the JAX
    package's r/g sort carrier unpacks to)."""
    resc = torch.where(torch.isfinite(raw.conic[:, 3]), raw.conic[:, 3],
                       torch.zeros_like(raw.conic[:, 3]))
    op = torch.where(torch.isfinite(raw.opacity), raw.opacity,
                     torch.zeros_like(raw.opacity))
    logro = torch.log(torch.clamp_min(resc * op, 1e-37))
    r, g = raw.color[:, 0], raw.color[:, 1]
    if pack_colors:
        r, g = round_bf16(r), round_bf16(g)
    return torch.stack(
        [raw.uv[:, 0], raw.uv[:, 1], raw.conic[:, 0], raw.conic[:, 1],
         raw.conic[:, 2], logro, r, g, raw.color[:, 2], raw.depth], dim=0)


@torch.no_grad()
def build_keys(raw: RawAttrs, radius, invalid_mask, camera: Camera,
               cfg: RasterizerConfig, key_cap: Optional[int] = None):
    """Tiling stage. Returns (keys, sorted (16, total) blend table, visible
    mask); with ``key_cap`` the capped key buffers
    (``tiling.build_tile_keys_and_table``). Takes no gradient."""
    visible = frustum_cull_mask(
        raw.uv, raw.depth, invalid_mask, camera.width, camera.height,
        cfg.near_plane, cfg.far_plane, _cfg_tile(cfg),
        boundary_tiles_v=cfg.cull_pad_v_tiles)
    keys, table = tiling.build_tile_keys_and_table(
        raw.uv, raw.depth, radius, visible, camera.width, camera.height,
        _cfg_tile(cfg), cfg.depth_to_sort_key_scale,
        attr_cols=attr_columns(raw, cfg.pack_sort_colors and cfg.rgb_only),
        exact_tile_cull=cfg.exact_tile_cull, key_cap=key_cap)
    return keys, table, visible


@torch.no_grad()
def key_total(xyz, features, invalid_mask, q_pointcloud_camera,
              t_pointcloud_camera, camera: Camera, cfg: RasterizerConfig,
              sh_max_band=3, point_object_id=None) -> int:
    """The frame's tile-key total (before the exact tile cull), read to the
    host: one sync. What the JAX package's capacity probes read as
    ``build_keys(...)[0].total``; no kernel runs."""
    raw, radius = compute_raw_attrs(xyz, features, q_pointcloud_camera,
                                    t_pointcloud_camera, camera, sh_max_band,
                                    point_object_id)
    visible = frustum_cull_mask(
        raw.uv, raw.depth, invalid_mask, camera.width, camera.height,
        cfg.near_plane, cfg.far_plane, _cfg_tile(cfg),
        boundary_tiles_v=cfg.cull_pad_v_tiles)
    return tiling.point_key_ranges(
        raw.uv, raw.depth, radius, visible, camera.width, camera.height,
        _cfg_tile(cfg), cfg.depth_to_sort_key_scale).total


def _assemble(out_tiles, camera: Camera, cfg: RasterizerConfig):
    tile = _cfg_tile(cfg)
    tiles_x = camera.width // tile[0]
    tiles_y = camera.height // tile[1]
    if cfg.rgb_only or cfg.slim:
        rgb = _tiles_to_image(out_tiles[..., 0:3], tiles_x, tiles_y, tile)
        zero = torch.zeros(rgb.shape[:2], dtype=torch.float32,
                           device=rgb.device)
        return RasterizeOutput(rgb=rgb, depth=zero, alpha=zero, count=zero)
    img = _tiles_to_image(out_tiles, tiles_x, tiles_y, tile)
    return RasterizeOutput(
        rgb=img[..., 0:3],
        depth=img[..., 3] / torch.clamp_min(img[..., 4], 1e-6),
        alpha=1.0 - img[..., 6],
        count=img[..., 5],
    )


def _blend_bwd_impl(raw: RawAttrs, keys: tiling.TileKeys, table, out_tiles,
                    d_rgb_tiles, tile, grid_hw, cfg: RasterizerConfig):
    """Per-point raw-attribute cotangents of the rgb tiles' cotangent
    ``d_rgb_tiles``, and the densification statistics (magnitude,
    affected pixels, |grad_uv| tiles). Only ``raw.conic`` and
    ``raw.opacity`` are read."""
    tiles_x, tiles_y = grid_hw
    d_table, imggrad_tiles = blend.blend_backward(
        table, keys.tile_start, keys.tile_end, d_rgb_tiles.contiguous(),
        out_tiles[..., 0:3].contiguous(), tile=tile, tiles_x=tiles_x,
        tiles_y=tiles_y, extra_info=cfg.extra_info, imggrad=not cfg.slim)
    # rows 0..11 (row 9 is zero) summed over each point's keys, which are
    # contiguous in pre-sort slot order: read in sorted order through the
    # inverse of the sort's permutation
    inv = tiling.inverse_permutation(keys.orig_slot)
    per_point = segment_reduce_sorted(d_table[0:12], inv, keys.offsets,
                                      keys.kept_counts)
    # split d_log(rescale * opacity) into the two exact cotangents
    d_logro = per_point[5]
    n = per_point.shape[1]
    d_raw = RawAttrs(
        uv=torch.stack([per_point[0], per_point[1]], dim=-1),
        cov2d=per_point.new_zeros((n, 3)),
        conic=torch.stack(
            [per_point[2], per_point[3], per_point[4],
             d_logro / torch.clamp_min(raw.conic[:, 3], 1e-12)], dim=-1),
        opacity=d_logro / torch.clamp_min(raw.opacity, 1e-12),
        color=torch.stack([per_point[6], per_point[7], per_point[8]], dim=-1),
        depth=per_point.new_zeros((n,)),
    )
    return d_raw, (per_point[10], per_point[11], imggrad_tiles)


def _blend(table, keys: tiling.TileKeys, tile, grid_hw,
           cfg: RasterizerConfig):
    return blend.blend_forward(
        table, keys.tile_start, keys.tile_end, tile=tile, tiles_x=grid_hw[0],
        tiles_y=grid_hw[1], rgb_only=cfg.rgb_only or cfg.slim)


class _BlendCore(torch.autograd.Function):
    """out_tiles = blend_forward(table); the table is a function of the
    raw fields (uv, conic, opacity, color) that arrives without a graph,
    and the backward (K4 -> K5) is its adjoint, returned as the
    raw fields' cotangents."""

    @staticmethod
    def forward(ctx, uv, conic, opacity, color, table, keys, tile, grid_hw,
                cfg):
        out_tiles = _blend(table, keys, tile, grid_hw, cfg)
        ctx.save_for_backward(conic, opacity, table, out_tiles)
        ctx.keys, ctx.tile, ctx.grid_hw, ctx.cfg = keys, tile, grid_hw, cfg
        return out_tiles

    @staticmethod
    def backward(ctx, d_out_tiles):
        conic, opacity, table, out_tiles = ctx.saved_tensors
        raw = RawAttrs(uv=None, cov2d=None, conic=conic, opacity=opacity,
                       color=None, depth=None)
        with stage("gs.blend_backward"):
            d_raw, _ = _blend_bwd_impl(raw, ctx.keys, table, out_tiles,
                                       d_out_tiles[..., 0:3], ctx.tile,
                                       ctx.grid_hw, ctx.cfg)
        return (d_raw.uv, d_raw.conic, d_raw.opacity, d_raw.color,
                None, None, None, None, None)


def rasterize(xyz: torch.Tensor, features: torch.Tensor,
              invalid_mask: torch.Tensor, q_pointcloud_camera: torch.Tensor,
              t_pointcloud_camera: torch.Tensor, camera: Camera,
              cfg: RasterizerConfig, sh_max_band=3,
              point_object_id: Optional[torch.Tensor] = None,
              return_num_keys: bool = False,
              key_cap: Optional[int] = None):
    """Render the scene into a camera view; differentiable with respect to
    xyz, features and the pose (q, t). Requires camera.width/height
    divisible by the tile. With ``return_num_keys`` also returns the number
    of tile keys of this frame: a host int, or with ``key_cap`` the true
    total as a () int64 device scalar (it may exceed key_cap).

    ``key_cap`` runs the frame on the capped key buffers (``build_keys``):
    no host sync, so the frame can be captured in a CUDA graph. Above the
    key total the frame is the exact frame bit for bit; below it the keys
    past the capacity are dropped, as the JAX package's ``rasterize`` at
    that ``key_cap`` drops them.

    The stages run inside ``ops.stages.stage`` ranges named ``gs.*``
    (``tools/profile_attribution.py`` sums device time by them; inside a
    graph capture they also mark the graph's replays on the device)."""
    tile = _cfg_tile(cfg)
    _check_size(camera, tile)
    pin_f32_matmul()
    grid_hw = (camera.width // tile[0], camera.height // tile[1])
    needs_grad = wants_grad(xyz, features, q_pointcloud_camera,
                            t_pointcloud_camera)
    with torch.set_grad_enabled(needs_grad):
        with stage("gs.attributes"):
            raw, radius = compute_raw_attrs(
                xyz, features, q_pointcloud_camera, t_pointcloud_camera,
                camera, sh_max_band, point_object_id)
        with stage("gs.tiling"):
            keys, table, _ = build_keys(raw, radius, invalid_mask, camera,
                                        cfg, key_cap)
        with stage("gs.blend"):
            out_tiles = _BlendCore.apply(raw.uv, raw.conic, raw.opacity,
                                         raw.color, table, keys, tile,
                                         grid_hw, cfg)
        with stage("gs.assemble"):
            out = _assemble(out_tiles, camera, cfg)
    if return_num_keys:
        return out, keys.total
    return out


def rasterize_fwd_ctx(xyz, features, invalid_mask, q_pointcloud_camera,
                      t_pointcloud_camera, camera: Camera,
                      cfg: RasterizerConfig, sh_max_band=3,
                      point_object_id=None, with_pose_grads: bool = False,
                      key_cap: Optional[int] = None):
    """Forward pass returning (output, RenderContext, attrs_vjp) for
    ``rasterize_bwd``. ``attrs_vjp(d_raw)`` maps raw-attribute cotangents
    to (d_xyz, d_features), or with ``with_pose_grads`` to (d_xyz,
    d_features, d_q, d_t). On a card without pose gradients the attributes
    take the kernel pair and no tape: ``point_attributes`` without grad,
    and ``attrs_vjp`` is ``point_attributes_vjp``, which recomputes each
    point. On the CPU, and with ``with_pose_grads`` (the pose cotangent
    sums over every point, which the kernel does not), they take autograd's
    tape of ``compute_raw_attrs``, and ``attrs_vjp`` can be called once.
    The output carries no graph. ``key_cap`` selects the capped key
    buffers (``build_keys``)."""
    tile = _cfg_tile(cfg)
    _check_size(camera, tile)
    pin_f32_matmul()
    if xyz.device.type == "cuda" and not with_pose_grads:
        x, f = xyz.detach(), features.detach()
        q, t = q_pointcloud_camera.detach(), t_pointcloud_camera.detach()
        with torch.no_grad(), stage("gs.attributes"):
            raw, radius = compute_raw_attrs(x, f, q, t, camera, sh_max_band,
                                            point_object_id)

        def attrs_vjp(d_raw: RawAttrs):
            return point_attributes_vjp(
                x, f, q, t, camera.K, sh_max_band, camera.row0,
                point_object_id, d_raw.uv, d_raw.conic, d_raw.opacity,
                d_raw.color)
    else:
        x = xyz.detach().requires_grad_(True)
        f = features.detach().requires_grad_(True)
        q = q_pointcloud_camera.detach().requires_grad_(with_pose_grads)
        t = t_pointcloud_camera.detach().requires_grad_(with_pose_grads)
        inputs = (x, f, q, t) if with_pose_grads else (x, f)
        with torch.enable_grad(), stage("gs.attributes"):
            raw, radius = compute_raw_attrs(x, f, q, t, camera, sh_max_band,
                                            point_object_id)

        def attrs_vjp(d_raw: RawAttrs):
            return torch.autograd.grad(
                (raw.uv, raw.conic, raw.opacity, raw.color), inputs,
                (d_raw.uv, d_raw.conic, d_raw.opacity, d_raw.color))
    with torch.no_grad():
        # radius only feeds the tiling stage: it is cut from the graph
        raw_values = RawAttrs(*(a.detach() for a in raw))
        with stage("gs.tiling"):
            keys, table, visible = build_keys(raw_values, radius.detach(),
                                              invalid_mask, camera, cfg,
                                              key_cap)
        with stage("gs.blend"):
            out_tiles = _blend(table, keys, tile,
                               (camera.width // tile[0],
                                camera.height // tile[1]), cfg)
            out = _assemble(out_tiles, camera, cfg)
    ctx = RenderContext(raw=raw_values, keys=keys, table=table,
                        out_tiles=out_tiles, visible=visible)
    return out, ctx, attrs_vjp


def rasterize_bwd(ctx: RenderContext, attrs_vjp, d_rgb: torch.Tensor,
                  camera: Camera, cfg: RasterizerConfig):
    """Backward from the (H, W, 3) image cotangent to ((d_xyz, d_features),
    GradStats), or ((d_xyz, d_features, d_q, d_t), GradStats) for a context
    made ``with_pose_grads``. Grad factors and SH-band masking are the
    trainer's."""
    tile = _cfg_tile(cfg)
    tiles_x = camera.width // tile[0]
    tiles_y = camera.height // tile[1]
    with torch.no_grad(), stage("gs.blend_backward"):
        d_rgb_tiles = _image_to_tiles(d_rgb, tiles_x, tiles_y, tile)
        d_raw, (mag, npix, imggrad_tiles) = _blend_bwd_impl(
            ctx.raw, ctx.keys, ctx.table, ctx.out_tiles, d_rgb_tiles, tile,
            (tiles_x, tiles_y), cfg)
        if cfg.slim:
            # the slim path skips the per-pixel |grad_uv| image
            imggrad_img = torch.zeros((1, 1, 2), dtype=torch.float32,
                                      device=d_rgb.device)
        else:
            imggrad_img = _tiles_to_image(imggrad_tiles, tiles_x, tiles_y,
                                          tile)
    with stage("gs.attributes_vjp"):
        grads = attrs_vjp(d_raw)
    stats = GradStats(
        grad_uv=d_raw.uv,
        magnitude_grad_viewspace=mag,
        num_affected_pixels=npix,
        num_overlap_tiles=ctx.keys.counts,
        in_camera=ctx.visible,
        magnitude_grad_viewspace_on_image=imggrad_img,
    )
    return grads, stats
