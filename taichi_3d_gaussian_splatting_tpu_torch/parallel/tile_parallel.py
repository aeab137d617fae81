"""Band-parallel (tile-parallel) rendering and training: one image split
across ranks.

Port of ``taichi_3d_gaussian_splatting_tpu/parallel/tile_parallel.py``.
The complement of ``parallel/data_parallel.py``: instead of one camera per
rank, ONE camera's image is split into horizontal bands of tile rows,
each rasterized by a different rank against the full (replicated)
Gaussian pool. Semantics match the single-device render:

- visibility is computed against the FULL image (the 3-tile boundary
  cull) and passed down as the invalid mask, so band membership never
  re-culls a splat another band's pixels need;
- each band renders through a camera of band_h rows that starts at image
  row ``rank * band_h`` (``Camera.row0``), with a vertical cull pad wide
  enough to accept every full-image-visible splat. The JAX package shifts
  the principal point instead (``K[1, 2] -= rank * band_h``); the band's v
  then comes out of the projection rounded otherwise than the full
  image's, and at 1920x1088 that round-off moved a pixel of the band
  frame 4.7e-4 from the single-device frame (an H100 run of
  chip_smoke.py phase 11). Taking the full image's v less row0 is one f32
  subtraction, exact for every splat centred in the band, so a band's
  pixels blend as the full image's do;
- splats whose extent misses a band produce EMPTY tile boxes
  (``tiling.tile_bbox``), so a band's key total is its own work, and a
  band with no keys runs the kernels on empty ranges.

The bands come together by one ``all_reduce`` (SUM) of a zero-filled
full image into which each rank writes its own rows (gloo refuses
``all_gather`` of CUDA tensors): every rank then holds the whole frame.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops.attributes import (
    frustum_cull_mask,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.projection import (
    project_point,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    GradStats,
    RasterizeOutput,
    RasterizerConfig,
    rasterize,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
    inverse_qt,
    quaternion_to_rotation_matrix,
)
from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh


def _tile_wh(cfg: RasterizerConfig) -> tuple:
    th = cfg.tile_size if cfg.tile_h is None else cfg.tile_h
    return cfg.tile_size, th


def band_layout(height: int, cfg: RasterizerConfig, n_bands: int):
    """(band_h, the band config): the height must divide into ``n_bands``
    bands of whole tile rows; the band config's vertical cull pad (in tile
    ROWS) covers the full image plus the full-image cull's 3*tile_w-px
    boundary pad."""
    tile_w, tile_h = _tile_wh(cfg)
    assert height % (n_bands * tile_h) == 0, (
        f"height {height} must divide {n_bands} bands of "
        f"{tile_h}-px tile rows")
    tiles_v_total = height // tile_h
    pad_rows = tiles_v_total + -(-3 * tile_w // tile_h)
    return height // n_bands, dataclasses.replace(cfg,
                                                  cull_pad_v_tiles=pad_rows)


def full_image_visibility(xyz, invalid_mask, q, t, K, width: int,
                          height: int, cfg: RasterizerConfig):
    """(visible (N,) bool, full-image uv (N, 2)): the single-device
    render's frustum cull, independent of the band."""
    q_cw, t_cw = inverse_qt(q.reshape(4), t.reshape(3))
    uv, xyz_cam = project_point(xyz, quaternion_to_rotation_matrix(q_cw),
                                t_cw, K)
    vis = frustum_cull_mask(uv, xyz_cam[:, 2], invalid_mask, width, height,
                            cfg.near_plane, cfg.far_plane, _tile_wh(cfg))
    return vis, uv


def band_camera(K: torch.Tensor, width: int, band_h: int,
                band: int) -> Camera:
    """The camera of band ``band``: band_h rows from image row band *
    band_h, with the full image's intrinsics."""
    return Camera(K=K, width=width, height=band_h, row0=band * band_h)


def gather_bands(parts, band: int, band_h: int, height: int, group=None,
                 log: Optional[list] = None):
    """Each (band_h, W, ...) band part -> the (height, W, ...) full image
    on every rank: zero-filled full images, this rank's rows written, one
    packed all_reduce (SUM)."""
    fulls = []
    for p in parts:
        full = p.new_zeros((height,) + tuple(p.shape[1:]))
        full[band * band_h:(band + 1) * band_h] = p
        fulls.append(full)
    return mh.all_reduce_packed(fulls, "sum", group=group, log=log)


def gather_output(out: RasterizeOutput, band: int, band_h: int,
                  height: int, rgb_only: bool, group=None,
                  log: Optional[list] = None) -> RasterizeOutput:
    """A band's RasterizeOutput -> the (height, W) image's on every rank
    (``gather_bands``); with ``rgb_only`` only rgb travels, and depth,
    alpha and count are zeros, as an rgb-only render's are."""
    parts = [out.rgb] if rgb_only else list(out)
    full = gather_bands(parts, band, band_h, height, group, log)
    if rgb_only:
        zero = full[0].new_zeros(full[0].shape[:2])
        return RasterizeOutput(rgb=full[0], depth=zero, alpha=zero,
                               count=zero)
    return RasterizeOutput(*full)


@torch.no_grad()
def rasterize_band_sharded(xyz, features, invalid_mask, q_pointcloud_camera,
                           t_pointcloud_camera, camera: Camera,
                           cfg: RasterizerConfig, group=None, sh_max_band=3,
                           point_object_id=None) -> RasterizeOutput:
    """Render one camera with its tile rows split over the ranks of
    ``group`` (rank r renders band r). Returns the full-image
    RasterizeOutput on every rank. A height that does not divide into
    world * tile_h rows is rendered up to the next multiple and cropped
    back, with visibility decided on the camera's own rows, so the frame
    is the single-device render's whatever the number of ranks."""
    n_bands = mh.world_size(group)
    band = mh.rank(group)
    rows = n_bands * _tile_wh(cfg)[1]
    padded_h = -(-camera.height // rows) * rows
    band_h, cfg_band = band_layout(padded_h, cfg, n_bands)
    vis, _ = full_image_visibility(
        xyz, invalid_mask, q_pointcloud_camera, t_pointcloud_camera,
        camera.K, camera.width, camera.height, cfg)
    out = rasterize(xyz, features, ~vis, q_pointcloud_camera,
                    t_pointcloud_camera,
                    band_camera(camera.K, camera.width, band_h, band),
                    cfg_band, sh_max_band=sh_max_band,
                    point_object_id=point_object_id)
    full = gather_output(out, band, band_h, padded_h, cfg.rgb_only, group)
    return RasterizeOutput(*(p[:camera.height] for p in full))


class BandSplit:
    """This rank's band of one camera in a band-parallel train step, as
    ``training.trainer.camera_pass`` takes it (``band=``):

    - the forward renders band ``mh.rank()`` (``camera``, ``cfg``) with
      the full image's cull as its invalid mask (``invalid``);
    - ``gather`` brings the bands' outputs together into the full image,
      on which the loss and its pixel cotangent are computed replicated
      (SSIM windows straddle band boundaries);
    - ``rows`` cuts the full image's cotangent to this band's rows;
    - ``reduce`` sums the band backward's per-point gradients and densify
      statistics over the ranks (pixels partition exactly, so the sums
      equal the single-device backward to float round-off) and takes the
      MAX of the bands' key totals (``num_keys``).

    ``uv`` is the full image's projected uv; the band's ``ctx.raw.uv`` is
    relative to its first row (``Camera.row0``). ``log`` lists the
    collectives."""

    def __init__(self, scene, q, t, K, width: int, height: int, band_h: int,
                 cfg_band: RasterizerConfig, rcfg: RasterizerConfig):
        self.index = mh.rank()
        self.band_h, self.height = band_h, height
        with torch.no_grad():
            self.visible, self.uv = full_image_visibility(
                scene.xyz, scene.invalid, q, t, K, width, height, rcfg)
        self.invalid = ~self.visible
        self.camera = band_camera(K, width, band_h, self.index)
        self.cfg = cfg_band
        self.log = []
        self.num_keys = None

    @torch.no_grad()
    def gather(self, out: RasterizeOutput) -> RasterizeOutput:
        return gather_output(out, self.index, self.band_h, self.height,
                             self.cfg.rgb_only or self.cfg.slim,
                             log=self.log)

    def rows(self, image: torch.Tensor) -> torch.Tensor:
        return image[self.index * self.band_h:
                     (self.index + 1) * self.band_h]

    @torch.no_grad()
    def reduce(self, grads, stats: GradStats, keys_total: int):
        """((d_xyz, d_features), GradStats) of the band -> the full
        image's, on every rank."""
        imggrad = stats.magnitude_grad_viewspace_on_image
        if not self.cfg.slim:  # the band's rows of the full image
            full = imggrad.new_zeros((self.height,) + imggrad.shape[1:])
            full[self.index * self.band_h:
                 (self.index + 1) * self.band_h] = imggrad
            imggrad = full
        parts = [grads[0], grads[1], stats.grad_uv,
                 stats.magnitude_grad_viewspace, stats.num_affected_pixels,
                 stats.num_overlap_tiles.to(torch.float32), imggrad]
        (d_xyz, d_features, grad_uv, mag, npix, ntiles,
         imggrad) = mh.all_reduce_packed(parts, "sum", log=self.log)
        (num_keys,) = mh.all_reduce_packed(
            [torch.tensor([float(keys_total)], dtype=torch.float64,
                          device=d_xyz.device)], "max", dtype=torch.float64,
            log=self.log)
        self.num_keys = num_keys[0].to(torch.int64)
        return (d_xyz, d_features), GradStats(
            grad_uv=grad_uv, magnitude_grad_viewspace=mag,
            num_affected_pixels=npix,
            num_overlap_tiles=ntiles.to(torch.int32), in_camera=self.visible,
            magnitude_grad_viewspace_on_image=imggrad)


def make_tp_train_step(config, height: int, width: int, device="cuda"):
    """Band-parallel TRAINING step: ONE camera per step, its tile rows
    split over the ranks: ``step(state, image_gt, q, t, K, sh_band,
    img_idx=-1) -> (new_state, metrics, aux)``, the single-device step
    (``training.trainer.make_train_step``) with each camera pass split
    into bands (``BandSplit``). The optimizer updates run replicated.

    Pose refinement does not compose with the band split (use
    data_parallel); densify stats follow the single-camera contract (one
    step = one frame). ``metrics["num_keys"]`` is the MAX of the bands'
    key totals and ``aux["band_keys"]`` this rank's; ``step.collectives``
    lists the collectives of the last call."""
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        make_train_step,
    )

    if config.pose_refinement:
        raise ValueError("pose_refinement does not compose with the "
                         "band-sharded step; use data_parallel")
    return make_train_step(config, height, width, device=device,
                           split_bands=True)
