"""Key expansion: per-point rows -> per-key fused sort keys + blend table.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/expand.py`` (``expand_keys``).
Each visible splat owns key slots [offsets[p], offsets[p] + counts[p]), one
per covered tile, decoded u-major within its tile bbox. The port sizes the
key buffer to the exact total, so there are no padding slots; keys retired
by the exact cull get the sentinel and sort past every tile's range.

CUDA tensors go to the kernel in ``csrc/expand.cu``; CPU tensors to the
plain version below. Both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

LOG255 = 5.541263545158426  # log(255): the 1/255 alpha-skip in log space
CULL_MARGIN = 1e-3  # keep pairs within fp jitter of the alpha threshold: the
                    # cull and the blend evaluate the quadratic with
                    # different expressions
CULL_BIAS = LOG255 + CULL_MARGIN  # a pair is culled when q_min > logro + this


def _nan_clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def rect_qmin(ca, cb, cc, x0, x1, y0, y1):
    """Minimum of the blend quadratic q = 1/2 (a dx^2 + c dy^2) + b dx dy
    over the rectangle [x0, x1] x [y0, y1] of offsets from the splat
    centre, for a positive-definite conic: 0 when the centre lies inside,
    else the least of the four edge minima. NaN propagates (a degenerate
    conic gives NaN). ``csrc/conic_cull.cuh`` takes the same operations in
    the same order."""

    def q_at(xx, yy):
        return 0.5 * (ca * xx * xx + cc * yy * yy) + cb * xx * yy

    def edge_x(xx):  # min over dy in [y0, y1] at fixed dx
        return q_at(xx, _nan_clip(-cb * xx / cc, y0, y1))

    def edge_y(yy):  # min over dx in [x0, x1] at fixed dy
        return q_at(_nan_clip(-cb * yy / ca, x0, x1), yy)

    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    qmin = torch.minimum(torch.minimum(edge_x(x0), edge_x(x1)),
                         torch.minimum(edge_y(y0), edge_y(y1)))
    return torch.where(inside, torch.zeros_like(qmin), qmin)


def expand_keys_plain(offsets, counts, dkey, base, h, attr_cols, *, total,
                      tiles_u, tile_w, tile_h, dbits, sentinel, exact_cull):
    """Plain PyTorch version of :func:`expand_keys` (same contract)."""
    n = offsets.shape[0]
    dev = offsets.device
    p = torch.repeat_interleave(torch.arange(n, device=dev), counts.long(),
                                output_size=total)
    k = torch.arange(total, device=dev, dtype=torch.int32)
    j = k - offsets[p]
    hh = torch.clamp_min(h[p], 1)
    du = torch.div(j, hh, rounding_mode="trunc")
    dv = j - du * hh
    tid = base[p] + du + dv * tiles_u
    cx = (tid % tiles_u).float() * tile_w
    cy = torch.div(tid, tiles_u, rounding_mode="trunc").float() * tile_h
    a = attr_cols[:, p]
    u_raw = a[0] - cx
    v_raw = a[1] - cy

    valid = torch.ones((total,), dtype=torch.bool, device=dev)
    if exact_cull:
        qmin = rect_qmin(a[2], a[3], a[4], 0.5 - u_raw,
                         (tile_w - 0.5) - u_raw, 0.5 - v_raw,
                         (tile_h - 0.5) - v_raw)
        valid = ~(qmin > a[5] + CULL_BIAS)

    fused = torch.where(valid, (tid << dbits) + dkey[p],
                        torch.full_like(tid, sentinel))
    zero = torch.zeros_like(u_raw)
    table = torch.cat([
        torch.stack([torch.where(valid, u_raw, zero),
                     torch.where(valid, v_raw, zero)]),
        a[2:10],
        p.float()[None],
        zero.expand(5, total),
    ])
    return fused, table


def expand_keys(offsets, counts, dkey, base, h, attr_cols, *, total: int,
                tiles_u: int, tile_w: int, tile_h: int, dbits: int,
                sentinel: int, exact_cull: bool):
    """Expand points into their tile keys.

    offsets, counts, dkey, base, h: (N,) int32 per point (key-slot offset,
    covered-tile count, depth key, first covered tile id, bbox tile height);
    attr_cols: (10, N) f32 [u, v, conic a, b, c, log(rescale*opacity), r, g,
    b, depth], finite. ``total`` must equal counts.sum().

    Returns (fused (total,) int32, table (16, total) f32), pre-sort order.
    """
    for name, t in (("offsets", offsets), ("counts", counts), ("dkey", dkey),
                    ("base", base), ("h", h)):
        cuda_build.require(t, name, torch.int32, 1)
    cuda_build.require(attr_cols, "attr_cols", torch.float32, 2)
    n = offsets.shape[0]
    if attr_cols.shape != (10, n) or any(
            t.shape != (n,) for t in (counts, dkey, base, h)):
        raise ValueError("expand_keys: per-point inputs must be (N,) and "
                         f"attr_cols (10, N); N={n}, attr_cols "
                         f"{tuple(attr_cols.shape)}")
    if not 0 <= total < 2 ** 31:
        raise ValueError(f"expand_keys: total={total} outside int32 slots")
    if offsets.device.type == "cpu":
        return expand_keys_plain(
            offsets, counts, dkey, base, h, attr_cols, total=total,
            tiles_u=tiles_u, tile_w=tile_w, tile_h=tile_h, dbits=dbits,
            sentinel=sentinel, exact_cull=exact_cull)
    dev = offsets.device
    fused = torch.empty((total,), dtype=torch.int32, device=dev)
    table = torch.empty((16, total), dtype=torch.float32, device=dev)
    if total == 0:
        return fused, table
    launch = cuda_build.bind("expand", "expand_keys_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(offsets.data_ptr(), dkey.data_ptr(), base.data_ptr(),
                 h.data_ptr(), attr_cols.data_ptr(), n, total, tiles_u,
                 tile_w, tile_h, dbits, sentinel, int(exact_cull),
                 CULL_BIAS, fused.data_ptr(), table.data_ptr(),
                 cuda_build.stream_of(offsets))
    expand_keys.launches += 1
    cuda_build.check(err, "expand_keys")
    return fused, table


expand_keys.launches = 0
