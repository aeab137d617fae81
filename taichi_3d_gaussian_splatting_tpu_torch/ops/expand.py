"""Key expansion: per-point rows -> per-key fused sort keys + blend table.

Port of ``taichi_3d_gaussian_splatting_tpu/ops/expand.py`` (``expand_keys``).
Each visible splat owns key slots [offsets[p], offsets[p] + counts[p]), one
per covered tile, decoded u-major within its tile bbox. The port sizes the
key buffer to the exact total, so there are no padding slots; keys retired
by the exact cull get the sentinel and sort past every tile's range.

``key_total`` selects the capped mode of the windowed train step: the
buffer holds ``total`` = key_cap slots and the key total is a device
scalar, read by the kernel, never by the host. The first min(key total,
key_cap) slots decode as above; the rest are padding (the sentinel, owned
by point 0), and the surplus keys of the highest-index points, those of
slots past key_cap, are dropped, as the JAX package's ``key_cap`` drops
them.

The TPU kernel wrote the keys and the table in pre-sort order, and the sort
carried the table as its payload. Here the main path runs two kernels
around the sort instead: ``slot_keys`` (K1a) writes the fused key and the
owning point of every slot, and after the sort ``sorted_table`` (K1b)
writes the table in sorted order, so the table is written once and never
gathered. ``expand_keys`` keeps the JAX contract (the pre-sort table: K1b
with the identity permutation) for the tests.

CUDA tensors go to the kernels in ``csrc/expand.cu``; CPU tensors to the
plain versions below. Both give the same bits, and both read non-finite
point columns as 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


def _slot_decode(offsets, counts, dkey, base, h, attr_cols, total, tiles_u,
                 tile_w, tile_h, dbits, sentinel, exact_cull, key_total=None):
    """Owner p (int64), tile-local centre (u_raw, v_raw), validity and
    fused key of every slot, and the owners' columns."""
    attr_cols = torch.nan_to_num(attr_cols, nan=0.0, posinf=0.0, neginf=0.0)
    n = offsets.shape[0]
    dev = offsets.device
    k = torch.arange(total, device=dev, dtype=torch.int32)
    live = None
    if key_total is None:
        p = torch.repeat_interleave(torch.arange(n, device=dev),
                                    counts.long(), output_size=total)
    else:
        # the cap-sized owner: the last point whose offset is <= k (a
        # zero-count point before the owner shares its offset); padding
        # slots take point 0
        live = k < torch.clamp(key_total, 0, total)
        p = torch.searchsorted(offsets, k, right=True) - 1
        p = torch.where(live, p, torch.zeros_like(p))
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
    if live is not None:
        valid = valid & live

    fused = torch.where(valid, (tid << dbits) + dkey[p],
                        torch.full_like(tid, sentinel))
    return p, u_raw, v_raw, valid, fused, a


def _table(u_raw, v_raw, valid, a, p):
    zero = torch.zeros_like(u_raw)
    return torch.cat([
        torch.stack([torch.where(valid, u_raw, zero),
                     torch.where(valid, v_raw, zero)]),
        a[2:10],
        p.float()[None],
        zero.expand(5, zero.shape[0]),
    ])


def expand_keys_plain(offsets, counts, dkey, base, h, attr_cols, *, total,
                      tiles_u, tile_w, tile_h, dbits, sentinel, exact_cull,
                      key_total=None):
    """Plain PyTorch version of :func:`expand_keys` (same contract), from
    the slot decode alone."""
    p, u_raw, v_raw, valid, fused, a = _slot_decode(
        offsets, counts, dkey, base, h, attr_cols, total, tiles_u, tile_w,
        tile_h, dbits, sentinel, exact_cull, key_total)
    return fused, _table(u_raw, v_raw, valid, a, p)


def slot_keys_plain(offsets, counts, dkey, base, h, attr_cols, *, total,
                    tiles_u, tile_w, tile_h, dbits, sentinel, exact_cull,
                    key_total=None):
    """Plain PyTorch version of :func:`slot_keys`: the fused keys of
    :func:`expand_keys_plain` and the owner from ``repeat_interleave`` (in
    the capped mode from ``searchsorted`` over the offsets)."""
    p, _, _, _, fused, _ = _slot_decode(
        offsets, counts, dkey, base, h, attr_cols, total, tiles_u, tile_w,
        tile_h, dbits, sentinel, exact_cull, key_total)
    return fused, p.to(torch.int32)


def sorted_table_plain(fused_s, perm, owner, attr_cols, *, tiles_u, tile_w,
                       tile_h, dbits, sentinel):
    """Plain PyTorch version of :func:`sorted_table` (same contract): each
    sorted key's point is ``owner[perm[i]]`` and its tile ``fused_s[i] >>
    dbits``."""
    p = owner.long() if perm is None else owner.long()[perm]
    tid = fused_s >> dbits
    a = torch.nan_to_num(attr_cols, nan=0.0, posinf=0.0, neginf=0.0)[:, p]
    u_raw = a[0] - (tid % tiles_u).float() * tile_w
    v_raw = a[1] - torch.div(tid, tiles_u, rounding_mode="trunc").float() * tile_h
    return _table(u_raw, v_raw, fused_s != sentinel, a, p)


def _require_columns(attr_cols, n: int) -> None:
    cuda_build.require(attr_cols, "attr_cols", torch.float32, 2)
    if attr_cols.shape != (10, n):
        raise ValueError(f"attr_cols must be (10, N); N={n}, got "
                         f"{tuple(attr_cols.shape)}")


def slot_keys(offsets, counts, dkey, base, h, attr_cols, *, total: int,
              tiles_u: int, tile_w: int, tile_h: int, dbits: int,
              sentinel: int, exact_cull: bool,
              key_total: Optional[torch.Tensor] = None):
    """K1a: the fused sort key and the owning point of every key slot.

    offsets, counts, dkey, base, h: (N,) int32 per point (key-slot offset,
    the exclusive cumsum of counts; covered-tile count; depth key; first
    covered tile id; bbox tile height); attr_cols: (10, N) f32 [u, v, conic
    a, b, c, log(rescale*opacity), r, g, b, depth], non-finite entries read
    as 0. ``total`` must equal counts.sum(); in the capped mode
    (``key_total``, the () int64 key total on the tensors' device, which
    may exceed ``total``) ``total`` is the key capacity: the slots from
    min(key_total, total) on are padding (sentinel, owner 0) and the keys
    past the capacity are dropped.

    Returns (fused (total,) int32, owner (total,) int32), pre-sort order.
    """
    for name, t in (("offsets", offsets), ("counts", counts), ("dkey", dkey),
                    ("base", base), ("h", h)):
        cuda_build.require(t, name, torch.int32, 1)
    n = offsets.shape[0]
    _require_columns(attr_cols, n)
    if any(t.shape != (n,) for t in (counts, dkey, base, h)):
        raise ValueError(f"slot_keys: per-point inputs must be (N,); N={n}")
    if not 0 <= total < 2 ** 31:
        raise ValueError(f"slot_keys: total={total} outside int32 slots")
    if key_total is not None:
        cuda_build.require(key_total, "key_total", torch.int64, 0)
        if key_total.device != offsets.device:
            raise ValueError("slot_keys: key_total lies on another device")
        if total > 0 and n == 0:
            raise ValueError("slot_keys: padding slots need a point to own "
                             "them")
    kw = dict(total=total, tiles_u=tiles_u, tile_w=tile_w, tile_h=tile_h,
              dbits=dbits, sentinel=sentinel, exact_cull=exact_cull,
              key_total=key_total)
    if offsets.device.type == "cpu":
        return slot_keys_plain(offsets, counts, dkey, base, h, attr_cols,
                               **kw)
    dev = offsets.device
    fused = torch.empty((total,), dtype=torch.int32, device=dev)
    owner = torch.empty((total,), dtype=torch.int32, device=dev)
    if total == 0:  # e.g. a band no splat reaches: nothing to launch
        return fused, owner
    launch = cuda_build.bind("expand", "slot_keys_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    err = launch(offsets.data_ptr(), dkey.data_ptr(), base.data_ptr(),
                 h.data_ptr(), attr_cols.data_ptr(), n, total,
                 None if key_total is None else key_total.data_ptr(),
                 tiles_u, tile_w, tile_h, dbits, sentinel, int(exact_cull),
                 CULL_BIAS, fused.data_ptr(), owner.data_ptr(),
                 cuda_build.stream_of(offsets))
    cuda_build.check(err, "slot_keys")
    slot_keys.launches += 1
    if key_total is not None:
        slot_keys.capped_launches += 1
    return fused, owner


def sorted_table(fused_s, perm, owner, attr_cols, *, tiles_u: int,
                 tile_w: int, tile_h: int, dbits: int, sentinel: int):
    """K1b: the (16, total) blend table in the order of ``fused_s``.

    fused_s: (total,) int32 keys, sorted or not; perm: (total,) int64 the
    pre-sort slot of each (``torch.sort``'s permutation), or None when
    ``fused_s`` is in slot order; owner: (total,) int32 point of each slot
    (``slot_keys``); attr_cols as :func:`slot_keys`'s. Rows: 0..9 the
    attributes with the splat centre tile-local (0 for a sentinel key), 10
    the point index, 11..15 zero.
    """
    cuda_build.require(fused_s, "fused_s", torch.int32, 1)
    cuda_build.require(owner, "owner", torch.int32, 1)
    total = fused_s.shape[0]
    if perm is not None:
        cuda_build.require(perm, "perm", torch.int64, 1)
        if perm.shape != (total,):
            raise ValueError(f"perm {tuple(perm.shape)} and fused_s "
                             f"{tuple(fused_s.shape)} differ")
    if owner.shape != (total,):
        raise ValueError(f"owner {tuple(owner.shape)} and fused_s "
                         f"{tuple(fused_s.shape)} differ")
    _require_columns(attr_cols, attr_cols.shape[-1])
    kw = dict(tiles_u=tiles_u, tile_w=tile_w, tile_h=tile_h, dbits=dbits,
              sentinel=sentinel)
    if fused_s.device.type == "cpu":
        return sorted_table_plain(fused_s, perm, owner, attr_cols, **kw)
    table = torch.empty((16, total), dtype=torch.float32,
                        device=fused_s.device)
    if total == 0:
        return table
    launch = cuda_build.bind("expand", "sorted_table_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    err = launch(fused_s.data_ptr(), None if perm is None else perm.data_ptr(),
                 owner.data_ptr(), attr_cols.data_ptr(), attr_cols.shape[1],
                 total, tiles_u, tile_w, tile_h, dbits, sentinel,
                 table.data_ptr(), cuda_build.stream_of(fused_s))
    cuda_build.check(err, "sorted_table")
    sorted_table.launches += 1
    return table


def expand_keys(offsets, counts, dkey, base, h, attr_cols, *, total: int,
                tiles_u: int, tile_w: int, tile_h: int, dbits: int,
                sentinel: int, exact_cull: bool,
                key_total: Optional[torch.Tensor] = None):
    """Expand points into their tile keys: the JAX contract.

    Inputs as :func:`slot_keys`'s. Returns (fused (total,) int32, table
    (16, total) f32), both in pre-sort order (``slot_keys``, then
    ``sorted_table`` with the identity permutation).
    """
    fused, owner = slot_keys(offsets, counts, dkey, base, h, attr_cols,
                             total=total, tiles_u=tiles_u, tile_w=tile_w,
                             tile_h=tile_h, dbits=dbits, sentinel=sentinel,
                             exact_cull=exact_cull, key_total=key_total)
    return fused, sorted_table(fused, None, owner, attr_cols, tiles_u=tiles_u,
                               tile_w=tile_w, tile_h=tile_h, dbits=dbits,
                               sentinel=sentinel)


slot_keys.launches = 0
slot_keys.capped_launches = 0  # of them, those in the capped mode
sorted_table.launches = 0
