"""Tile blend, forward: front-to-back compositing of per-tile key ranges.

Port of the forward half of ``taichi_3d_gaussian_splatting_tpu/ops/
blend_pallas.py`` (``blend_forward``). CUDA tensors go to the kernel in
``csrc/blend.cu`` (one block per tile, a sequential transmittance per
pixel); CPU tensors to the plain version below (per tile, a dense
(pixels, keys) cumulative product, as ``blend_reference.blend_dense``).

Table layout (16, cap) f32, one column per sorted key: rows 0..5 u_local,
v_local, conic_a, conic_b, conic_c, log(rescale * opacity); rows 6..9 r, g,
b, depth; rows 10..15 unused here.
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build
from taichi_3d_gaussian_splatting_tpu_torch.ops.tiling import tile_wh

ALPHA_SKIP_EPS = 1.0 / 255.0
ALPHA_CLAMP = 0.99
T_SATURATION_EPS = 1e-4
MAX_TILE_PIXELS = 1024  # one CUDA thread per pixel


def _pixel_centres(tile_w: int, tile_h: int, device):
    i = torch.arange(tile_w * tile_h, device=device)
    x = (i % tile_w).float() + 0.5
    y = torch.div(i, tile_w, rounding_mode="floor").float() + 0.5
    return x[:, None], y[:, None]


def blend_forward_plain(table, tile_start, tile_end, *, tile, tiles_x: int,
                        tiles_y: int, rgb_only: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`blend_forward` (same contract)."""
    tile_w, tile_h = tile_wh(tile)
    npx = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    out = torch.zeros((num_tiles, npx, 8), dtype=torch.float32,
                      device=table.device)
    out[..., 6] = 1.0
    x, y = _pixel_centres(tile_w, tile_h, table.device)
    for t, (s, e) in enumerate(zip(tile_start.tolist(), tile_end.tolist())):
        if e <= s:
            continue
        tab = table[:, s:e]
        dx = x - tab[0]
        dy = y - tab[1]
        power = (-0.5 * (tab[2] * dx * dx + tab[4] * dy * dy)
                 - tab[3] * dx * dy + tab[5])
        alpha = torch.exp(power)
        skip = ~(alpha >= ALPHA_SKIP_EPS)  # catches NaN too
        a = torch.where(skip, torch.zeros_like(alpha),
                        torch.clamp_max(alpha, ALPHA_CLAMP))
        om = 1.0 - a
        p_incl = torch.cumprod(om, dim=1)
        p_excl = torch.cat([torch.ones_like(p_incl[:, :1]), p_incl[:, :-1]], 1)
        include = ~skip & (p_incl >= T_SATURATION_EPS)
        w = torch.where(include, a * p_excl, torch.zeros_like(a))
        if rgb_only:
            out[t, :, 0:3] = w @ tab[6:9].T
            continue
        out[t, :, 0:4] = w @ tab[6:10].T
        out[t, :, 4] = w.sum(1)
        out[t, :, 5] = include.sum(1).float()
        out[t, :, 6] = torch.where(include, om, torch.ones_like(om)).prod(1)
    return out


def blend_forward(table: torch.Tensor, tile_start: torch.Tensor,
                  tile_end: torch.Tensor, *, tile, tiles_x: int, tiles_y: int,
                  rgb_only: bool = False) -> torch.Tensor:
    """Blend every tile's key range [tile_start[t], tile_end[t]) of the
    sorted table. Returns (num_tiles, tile_w*tile_h, 8) f32 per pixel:
    [r, g, b, sum w*depth, sum w, count, T_final, 0]; with ``rgb_only`` only
    r, g, b are blended and the rest reads [0, 0, 0, 1, 0]. ``tile``: int
    (square) or (tile_w, tile_h), at most 1024 pixels."""
    tile_w, tile_h = tile_wh(tile)
    num_tiles = tiles_x * tiles_y
    cuda_build.require(table, "table", torch.float32, 2)
    cuda_build.require(tile_start, "tile_start", torch.int32, 1)
    cuda_build.require(tile_end, "tile_end", torch.int32, 1)
    if table.shape[0] != 16:
        raise ValueError(f"table must be (16, cap), got {tuple(table.shape)}")
    if tile_start.shape != (num_tiles,) or tile_end.shape != (num_tiles,):
        raise ValueError(f"tile ranges must be ({num_tiles},)")
    if not 1 <= tile_w * tile_h <= MAX_TILE_PIXELS:
        raise ValueError(f"tile {tile_w}x{tile_h} exceeds {MAX_TILE_PIXELS} px")
    if table.device.type == "cpu":
        return blend_forward_plain(table, tile_start, tile_end, tile=tile,
                                   tiles_x=tiles_x, tiles_y=tiles_y,
                                   rgb_only=rgb_only)
    out = torch.empty((num_tiles, tile_w * tile_h, 8), dtype=torch.float32,
                      device=table.device)
    if num_tiles == 0:
        return out
    launch = cuda_build.bind("blend", "blend_forward_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p])
    err = launch(table.data_ptr(), table.shape[1], tile_start.data_ptr(),
                 tile_end.data_ptr(), num_tiles, tile_w, tile_h,
                 int(rgb_only), out.data_ptr(), cuda_build.stream_of(table))
    blend_forward.launches += 1
    cuda_build.check(err, "blend_forward")
    return out


blend_forward.launches = 0
