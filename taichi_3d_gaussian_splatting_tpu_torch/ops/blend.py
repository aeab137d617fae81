"""Tile blend: front-to-back compositing of per-tile key ranges, and its
backward.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py``
(``blend_forward`` and ``blend_backward``). CUDA tensors go to the kernels
in ``csrc/blend.cu`` and ``csrc/blend_backward.cu`` (one block per tile,
heaviest tiles first, a sequential transmittance per pixel, each warp
walking only the keys that may reach one of its pixels:
``warp_key_cull_plain``); CPU tensors to the plain versions
below (the forward per tile as a dense (pixels, keys) cumulative product,
as ``blend_reference.blend_dense``; the backward as every tile's keys
walked in step, vectorized over tiles and pixels).

Table layout (16, cap) f32, one column per sorted key: rows 0..5 u_local,
v_local, conic_a, conic_b, conic_c, log(rescale * opacity); rows 6..9 r, g,
b, depth; rows 10..15 unused here.

Backward output d_table (16, cap) f32: rows 0 d_u, 1 d_v, 2 d_conic_a,
3 d_conic_b, 4 d_conic_c, 5 d_log(rescale * opacity), 6..8 d_r, d_g, d_b,
9 zero, 10 sum over pixels of |grad_uv|, 11 affected-pixel count, 12..15
zero. Every lane outside all tile ranges is zero (the segment reduction
sums them).
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build
from taichi_3d_gaussian_splatting_tpu_torch.ops.blend_reference import (
    ALPHA_CLAMP,
    ALPHA_SKIP_EPS,
    T_SATURATION_EPS,
    straight_through_clamp,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.expand import (
    CULL_BIAS,
    rect_qmin,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.tiling import tile_wh

__all__ = ["ALPHA_CLAMP", "ALPHA_SKIP_EPS", "T_SATURATION_EPS",
           "blend_forward", "blend_forward_plain", "blend_backward",
           "blend_backward_plain", "rect_key_cull_plain", "row_major_warps",
           "warp_key_cull_plain", "warp_layout"]

MAX_TILE_PIXELS = 1024  # one CUDA thread per pixel
WARP = 32
# the warp cull keeps a key unless its quadratic's minimum over the warp's
# rectangle exceeds logro + log 255 + 1e-3 (K1's tile test) by more than
# this share of the magnitudes the blend's f32 exponent rounds at
WARP_CULL_SLACK = 2.0 ** -19


def _pixel_centres(tile_w: int, tile_h: int, device):
    i = torch.arange(tile_w * tile_h, device=device)
    x = (i % tile_w).float() + 0.5
    y = torch.div(i, tile_w, rounding_mode="floor").float() + 0.5
    return x[:, None], y[:, None]


def warp_layout(tile_w: int, tile_h: int, device=None):
    """The blend kernels' thread -> pixel map (``csrc/warp_layout.cuh``):
    (pixel (npx,) long, the row-major pixel index thread i takes; x0, x1,
    y0, y1, each (num_warps, 1) f32, the pixel-centre rectangle of each
    warp of 32 threads). When tile_w % 8 == 0 and tile_h % 4 == 0 a warp
    takes an 8x4 block of pixels (lane l: column l % 8, row l // 8), the
    blocks in row-major order; otherwise thread i takes pixel i and a
    warp's rectangle covers whole rows when it spans rows."""
    if tile_w % 8 == 0 and tile_h % 4 == 0:
        npx = tile_w * tile_h
        t = torch.arange(npx, device=device)
        w0 = torch.arange(0, npx, WARP, device=device)  # a warp's 1st thread
        per_row = tile_w // 8

        def origin(tt):  # (column, row) of the thread's warp block
            w = torch.div(tt, WARP, rounding_mode="floor")
            return (w % per_row) * 8, torch.div(
                w, per_row, rounding_mode="floor") * 4
        cx, cy = origin(t)
        lane = t % WARP
        pixel = (cy + torch.div(lane, 8, rounding_mode="floor")) * tile_w \
            + cx + lane % 8
        c0, r0 = origin(w0)
        c1, r1 = c0 + 7, r0 + 3
        return (pixel,) + tuple(c.float()[:, None] + 0.5
                                for c in (c0, c1, r0, r1))
    return row_major_warps(tile_w, tile_h, device)


def row_major_warps(tile_w: int, tile_h: int, device=None):
    """:func:`warp_layout`'s fallback: thread i takes pixel i, and a warp's
    rectangle covers whole rows when it spans rows."""
    npx = tile_w * tile_h
    w0 = torch.arange(0, npx, WARP, device=device)  # first thread of a warp
    p1 = torch.clamp_max(w0 + WARP - 1, npx - 1)
    r0 = torch.div(w0, tile_w, rounding_mode="floor")
    r1 = torch.div(p1, tile_w, rounding_mode="floor")
    one_row = r0 == r1
    c0 = torch.where(one_row, w0 % tile_w, torch.zeros_like(w0))
    c1 = torch.where(one_row, p1 % tile_w, torch.full_like(p1, tile_w - 1))
    return (torch.arange(npx, device=device),) + tuple(
        c.float()[:, None] + 0.5 for c in (c0, c1, r0, r1))


def warp_key_cull_plain(tab: torch.Tensor, *, tile) -> torch.Tensor:
    """Which keys each warp of a tile must evaluate: (num_warps, n) bool
    for the table columns ``tab`` (rows u, v, conic a, b, c, logro, ...);
    warps as in :func:`warp_layout`.

    The kernels' per-warp cull (``csrc/conic_cull.cuh``), in the same f32
    operations: a key is dropped for a warp when its quadratic's minimum
    over the warp's pixel-centre rectangle exceeds logro + log 255 + 1e-3
    (K1's tile test) + WARP_CULL_SLACK x the magnitude of the exponent's
    terms, so no pixel of the warp can reach alpha >= 1/255 in f32. A
    conic that is NaN or not positive definite is never dropped. The
    kernels do not call this; the tests do."""
    tile_w, tile_h = tile_wh(tile)
    return rect_key_cull_plain(tab, *warp_layout(tile_w, tile_h,
                                                 tab.device)[1:])


def rect_key_cull_plain(tab, px0, px1, py0, py1) -> torch.Tensor:
    """:func:`warp_key_cull_plain` for any rectangles of pixel centres
    (each (m, 1) f32): (m, n) bool."""
    u, v, ca, cb, cc, logro = (tab[i][None, :] for i in range(6))
    x0, x1, y0, y1 = px0 - u, px1 - u, py0 - v, py1 - v
    pd = (ca > 0.0) & (cc > 0.0) & (ca * cc > cb * cb)
    xm = torch.maximum(x0.abs(), x1.abs())
    ym = torch.maximum(y0.abs(), y1.abs())
    mag = (0.5 * (ca * xm * xm + cc * ym * ym) + cb.abs() * xm * ym
           + logro.abs())
    qmin = rect_qmin(ca, cb, cc, x0, x1, y0, y1)
    return ~pd | ~(qmin > logro + (CULL_BIAS + WARP_CULL_SLACK * mag))


def _tile_state(tab, x, y):
    """Dense (pixels, keys) state of one tile's sorted keys ``tab``: the
    unclamped alpha, the clamped alpha a (0 where skipped), 1 - a, the
    inclusive and exclusive transmittance products, the inclusion mask and
    the pixel offsets dx, dy. The clamp is straight-through, so autograd
    through this function gives the reference's gradients."""
    dx = x - tab[0]
    dy = y - tab[1]
    power = (-0.5 * (tab[2] * dx * dx + tab[4] * dy * dy)
             - tab[3] * dx * dy + tab[5])
    alpha = torch.exp(power)
    skip = ~(alpha >= ALPHA_SKIP_EPS)  # catches NaN too
    a = torch.where(skip, torch.zeros_like(alpha),
                    straight_through_clamp(alpha))
    om = 1.0 - a
    p_incl = torch.cumprod(om, dim=1)
    p_excl = torch.cat([torch.ones_like(p_incl[:, :1]), p_incl[:, :-1]], 1)
    include = ~skip & (p_incl >= T_SATURATION_EPS)
    return alpha, a, om, p_incl, p_excl, include, dx, dy


def blend_forward_plain(table, tile_start, tile_end, *, tile, tiles_x: int,
                        tiles_y: int, rgb_only: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`blend_forward` (same contract);
    differentiable with respect to ``table``."""
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
        _, a, om, _, p_excl, include, _, _ = _tile_state(tab, x, y)
        w = torch.where(include, a * p_excl, torch.zeros_like(a))
        if rgb_only:
            out[t, :, 0:3] = w @ tab[6:9].T
            continue
        out[t, :, 0:4] = w @ tab[6:10].T
        out[t, :, 4] = w.sum(1)
        out[t, :, 5] = include.sum(1).float()
        out[t, :, 6] = torch.where(include, om, torch.ones_like(om)).prod(1)
    return out


def _check_blend_args(table, tile_start, tile_end, tile, tiles_x, tiles_y):
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
    return tile_w, tile_h, num_tiles


def blend_forward(table: torch.Tensor, tile_start: torch.Tensor,
                  tile_end: torch.Tensor, *, tile, tiles_x: int, tiles_y: int,
                  rgb_only: bool = False) -> torch.Tensor:
    """Blend every tile's key range [tile_start[t], tile_end[t]) of the
    sorted table. Returns (num_tiles, tile_w*tile_h, 8) f32 per pixel:
    [r, g, b, sum w*depth, sum w, count, T_final, 0]; with ``rgb_only`` only
    r, g, b are blended and the rest reads [0, 0, 0, 1, 0]. ``tile``: int
    (square) or (tile_w, tile_h), at most 1024 pixels."""
    tile_w, tile_h, num_tiles = _check_blend_args(
        table, tile_start, tile_end, tile, tiles_x, tiles_y)
    if table.device.type == "cpu":
        return blend_forward_plain(table, tile_start, tile_end, tile=tile,
                                   tiles_x=tiles_x, tiles_y=tiles_y,
                                   rgb_only=rgb_only)
    out = torch.empty((num_tiles, tile_w * tile_h, 8), dtype=torch.float32,
                      device=table.device)
    if num_tiles == 0:
        return out
    order = torch.empty((num_tiles,), dtype=torch.int32, device=table.device)
    launch = cuda_build.bind("blend", "blend_forward_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(table.data_ptr(), table.shape[1], tile_start.data_ptr(),
                 tile_end.data_ptr(), order.data_ptr(), num_tiles, tile_w,
                 tile_h, int(rgb_only), CULL_BIAS, out.data_ptr(),
                 cuda_build.stream_of(table))
    blend_forward.launches += 1
    cuda_build.check(err, "blend_forward")
    return out


blend_forward.launches = 0


def blend_backward_plain(table, tile_start, tile_end, d_rgb_tiles,
                         cfin_tiles, *, tile, tiles_x: int, tiles_y: int,
                         extra_info: bool = True, imggrad: bool = True):
    """Plain PyTorch version of :func:`blend_backward` (same contract).

    Every tile walks its keys front to back at once (step j takes key j of
    each tile), vectorized over tiles and pixels, with the kernel's
    per-pixel f32 operations in the kernel's order; the pixel sums are
    ``torch.sum``. The closed form, per pixel and key, with C the forward's
    rgb and A the per-channel prefix of c w up to and including the key:
    dL/dalpha = (g.c) T - g.(C - A) / (1 - a), de = dL/dalpha * alpha.
    (A dense cumulative product over each tile's keys, as the forward's
    plain version takes, rounds the prefix otherwise and leaves g.(C - A)
    to cancel in f32: at the full-width frame that alone moves a key's
    conic gradient by ~1e-3 of its value.)"""
    tile_w, tile_h = tile_wh(tile)
    npx = tile_w * tile_h
    num_tiles = tiles_x * tiles_y
    dev = table.device
    cap = table.shape[1]
    # one spare column takes the writes of tiles past their last key
    d_table = torch.zeros((16, cap + 1), dtype=torch.float32, device=dev)
    img = torch.zeros((num_tiles, npx, 2), dtype=torch.float32, device=dev)
    start = tile_start.long()
    n = torch.clamp_min(tile_end.long() - start, 0)
    steps = int(n.max()) if num_tiles else 0
    if steps == 0:
        return d_table[:, :cap], img
    x, y = (c.T for c in _pixel_centres(tile_w, tile_h, dev))  # (1, npx)
    g = [d_rgb_tiles[..., c] for c in range(3)]  # (T, npx) each
    cf = [cfin_tiles[..., c] for c in range(3)]
    zero = torch.zeros((num_tiles, npx), dtype=torch.float32, device=dev)
    T = torch.ones_like(zero)
    acc = [zero, zero, zero]
    done = torch.zeros((num_tiles, npx), dtype=torch.bool, device=dev)
    img_acc = torch.zeros((2, num_tiles, npx), dtype=torch.float32,
                          device=dev)
    rows = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11][
        :11 if extra_info else 9], device=dev)[:, None]
    for j in range(steps):
        if j % 64 == 0 and bool((done | (n[:, None] <= j)).all()):
            break  # every pixel has stopped or run out of keys
        live = n > j
        col = torch.where(live, start + j, cap)
        tab = table[:, torch.clamp_max(col, cap - 1)][:, :, None]  # (16, T, 1)
        u, v, ca, cb, cc, logro, r, gg, b = (tab[i] for i in range(9))
        dx = x - u
        dy = y - v
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy + logro
        alpha = torch.exp(power)
        hit = (alpha >= ALPHA_SKIP_EPS) & live[:, None] & ~done
        a = torch.clamp_max(alpha, ALPHA_CLAMP)
        om = 1.0 - a
        nxt = T * om
        stop = hit & (nxt < T_SATURATION_EPS)
        done = done | stop
        inc = hit & ~stop
        gc = g[0] * r + g[1] * gg + g[2] * b
        w = a * T
        acc_new = [acc[0] + w * r, acc[1] + w * gg, acc[2] + w * b]
        s_after = (g[0] * (cf[0] - acc_new[0]) + g[1] * (cf[1] - acc_new[1])
                   + g[2] * (cf[2] - acc_new[2]))
        dalpha = gc * T - s_after / om
        de = dalpha * alpha
        gx = de * (ca * dx + cb * dy)
        gy = de * (cb * dx + cc * dy)
        vals = [gx, gy, -0.5 * (de * dx * dx), -(de * dx * dy),
                -0.5 * (de * dy * dy), de, g[0] * w, g[1] * w, g[2] * w]
        if extra_info:
            vals += [torch.sqrt(gx * gx + gy * gy), torch.ones_like(gx)]
        terms = torch.where(inc, torch.stack(vals), zero)  # (rows, T, npx)
        d_table[rows, col[None]] = terms.sum(2)
        if extra_info and imggrad:
            img_acc = img_acc + terms[0:2].abs()
        acc = [torch.where(inc, an, ao) for an, ao in zip(acc_new, acc)]
        T = torch.where(inc, nxt, T)
    if extra_info and imggrad:
        img = img_acc.permute(1, 2, 0).contiguous()
    return d_table[:, :cap].contiguous(), img


def blend_backward(table: torch.Tensor, tile_start: torch.Tensor,
                   tile_end: torch.Tensor, d_rgb_tiles: torch.Tensor,
                   cfin_tiles: torch.Tensor, *, tile, tiles_x: int,
                   tiles_y: int, extra_info: bool = True,
                   imggrad: bool = True):
    """Gradients of sum(d_rgb * rgb) with respect to every sorted key's
    table column, recomputing the forward. ``d_rgb_tiles``: (num_tiles, px,
    3) image cotangent; ``cfin_tiles``: (num_tiles, px, 3) the forward's
    rgb. Returns (d_table (16, cap) f32, |grad_uv| image (num_tiles, px,
    2) f32). ``extra_info`` fills rows 10, 11; ``imggrad`` (with
    ``extra_info``) the image, which is zero otherwise."""
    tile_w, tile_h, num_tiles = _check_blend_args(
        table, tile_start, tile_end, tile, tiles_x, tiles_y)
    npx = tile_w * tile_h
    for name, a in (("d_rgb_tiles", d_rgb_tiles), ("cfin_tiles", cfin_tiles)):
        cuda_build.require(a, name, torch.float32, 3)
        if a.shape != (num_tiles, npx, 3):
            raise ValueError(f"{name} must be ({num_tiles}, {npx}, 3), got "
                             f"{tuple(a.shape)}")
    if table.device.type == "cpu":
        return blend_backward_plain(
            table, tile_start, tile_end, d_rgb_tiles, cfin_tiles, tile=tile,
            tiles_x=tiles_x, tiles_y=tiles_y, extra_info=extra_info,
            imggrad=imggrad)
    if npx % 32:
        raise ValueError(f"tile {tile_w}x{tile_h}: the CUDA backward needs "
                         "a pixel count that is a multiple of 32")
    d_table = torch.zeros((16, table.shape[1]), dtype=torch.float32,
                          device=table.device)
    img = torch.empty((num_tiles, npx, 2), dtype=torch.float32,
                      device=table.device)
    if num_tiles == 0:
        return d_table, img
    order = torch.empty((num_tiles,), dtype=torch.int32, device=table.device)
    launch = cuda_build.bind("blend_backward", "blend_backward_launch", [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(table.data_ptr(), table.shape[1], tile_start.data_ptr(),
                 tile_end.data_ptr(), order.data_ptr(), d_rgb_tiles.data_ptr(),
                 cfin_tiles.data_ptr(), num_tiles, tile_w, tile_h,
                 int(extra_info), int(extra_info and imggrad),
                 CULL_BIAS, d_table.data_ptr(), img.data_ptr(),
                 cuda_build.stream_of(table))
    blend_backward.launches += 1
    cuda_build.check(err, "blend_backward")
    return d_table, img


blend_backward.launches = 0
