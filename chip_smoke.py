#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out record.json]

Builds the port's CUDA kernels from ``taichi_3d_gaussian_splatting_tpu_torch/
csrc`` with nvcc (sm_90a, one nvcc per source, all at once), then:

1. holds each kernel against its plain PyTorch version on the card, on the
   same inputs: a small frame (64x64, 200 points) and the full-width frame
   (428,687 points, 960x544, 32x32 tiles). expand_keys and bucket_histogram
   must match bit for bit; blend_forward within 1e-4 (rgb, alpha) and 5e-4
   (depth), with the count exact at the small size and differing on under
   0.01% of the full-width pixels (the plain version's parallel cumprod may
   flip a pixel sitting on the 1e-4 stop);
2. renders 9 full-width frames through ``apps/render.py``'s
   GaussianPointRenderer (the user's entry point; the scene goes through a
   .ply file), with every kernel's launch count set to 0 before and read
   after; checks the frames, and one full-output frame against the plain
   blend;
3. times the render with CUDA events after a warm-up, each stage's wall
   and device time, and each kernel's device time (torch.profiler) beside
   its plain version's, torch.bincount's (K2's yardstick) and the kernel's
   bound on an H100 SXM; counts the (pixel, key) pairs the blend kernels
   walk per pixel, per warp and per block, and the warp key steps their
   per-warp cull keeps (``walked_pairs``);
1b. (run after 1) holds the backward kernels against their plain versions
   at both sizes, with a seeded image cotangent and the forward's own rgb:
   blend_backward's rows within 5e-4 + 1e-3 |plain| (the JAX package's
   gradient gate), its count exact at 64x64 and differing on under 0.01%
   of the full-width keys, its |grad_uv| image within 1e-4, and two runs
   bit-identical; segment_reduce within 1e-5 (1 + sum of |terms|) (the
   plain index_add_ adds with atomics on the card);
4. trains at full width through ``training/trainer.py``'s make_train_step
   (bench.py's train step: TrainConfig defaults, SH degree 3): 3 warm-up
   and 20 timed steps from a state made by ``convert.train_state_from_jax``
   of numpy arrays, towards a uint8 target rendered from the same scene
   with seeded noise on its DC colours. Checks every loss and gradient
   finite, the loss falling, and every kernel launched in the timed steps
   (blend_backward and segment_reduce once a step); times the step, its
   stages and the device's busy share.

The scene is a seeded copy of bench.py's surround scene (random weights).
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises, so the process
exits non-zero; without a CUDA card it exits 1 before doing anything.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 flop/s
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

N_POINTS = 428_687          # bench.py: the Truck 30k checkpoint size
HEIGHT, WIDTH = 544, 960    # bench.py: ~980x546 views cropped to 32-px tiles
TILE = 32


# --- scenes (numpy, seeded) ---------------------------------------------

def truck_feats(rng, n: int) -> np.ndarray:
    """bench.py::_truck_feats: random Gaussians sized to cover a handful of
    pixels at street-scale depth."""
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    scale_shift = -0.5 * np.log(max(n / N_POINTS, 1.0))
    feats[:, 4:7] = rng.uniform(-4.5, -2.0, (n, 3)) + scale_shift
    feats[:, 7] = rng.uniform(-2.0, 3.0, n)
    feats[:, 8:] = (rng.normal(size=(n, 48)) * 0.3).astype(np.float32)
    return feats


def truck_scene_surround(n: int, seed: int = 0, visible_frac: float = 0.6):
    """bench.py::synthetic_truck_scene_surround: 60% of the points in front
    of the identity camera, the rest on a shell behind and beside it."""
    rng = np.random.default_rng(seed)
    n_vis = int(n * visible_frac)
    n_out = n - n_vis
    vis = np.stack(
        [rng.uniform(-8.0, 8.0, n_vis), rng.uniform(-4.0, 4.0, n_vis),
         rng.uniform(1.0, 30.0, n_vis)], axis=-1)
    theta = rng.uniform(np.pi * 0.6, np.pi * 1.4, n_out)
    rad = rng.uniform(5.0, 30.0, n_out)
    out = np.stack(
        [rad * np.sin(theta), rng.uniform(-4.0, 4.0, n_out),
         rad * np.cos(theta)], axis=-1)
    xyz = np.concatenate([vis, out], axis=0).astype(np.float32)
    perm = rng.permutation(n)
    return xyz[perm], truck_feats(rng, n)


def small_scene(n=200, seed=7):
    """tests/test_rasterizer.py::make_scene (64x64 view, 1/20 invalid)."""
    rng = np.random.default_rng(seed)
    xyz = np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
         rng.uniform(2.0, 8.0, n)], axis=-1).astype(np.float32)
    feats = np.zeros((n, 56), np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-3.5, -1.5, (n, 3))
    feats[:, 7] = rng.uniform(-1.0, 3.0, n)
    feats[:, 8:] = rng.normal(size=(n, 48)) * 0.3
    invalid = np.zeros((n,), bool)
    invalid[: n // 20] = True
    return xyz, feats, invalid


def poses(count=9):
    """Camera->world poses: the identity, then small turns and shifts."""
    out = [np.eye(4, dtype=np.float32)]
    for i in range(1, count):
        a = 0.02 * i * (-1) ** i
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]]
        p[:3, 3] = [0.05 * i * (-1) ** i, 0.02 * i, 0.1 * i]
        out.append(p)
    return np.stack(out)


# --- helpers ------------------------------------------------------------

def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device ms of fn() over reps calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


class Frame:
    """Every intermediate of one rasterize call, from the port's own
    stages, so each kernel can be called on the main path's inputs."""

    def __init__(self, xyz, feats, invalid, q, t, camera, cfg):
        from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
        from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

        self.camera, self.cfg = camera, cfg
        self.tile = R._cfg_tile(cfg)
        self.tiles_x = camera.width // self.tile[0]
        self.tiles_y = camera.height // self.tile[1]
        self.num_tiles = self.tiles_x * self.tiles_y
        self.dbits = tiling._depth_bits(self.num_tiles)
        raw, radius = R.compute_raw_attrs(xyz, feats, q, t, camera)
        visible = R.frustum_cull_mask(
            raw.uv, raw.depth, invalid, camera.width, camera.height,
            cfg.near_plane, cfg.far_plane, self.tile)
        r = tiling.point_key_ranges(raw.uv, raw.depth, radius, visible,
                                    camera.width, camera.height, self.tile,
                                    cfg.depth_to_sort_key_scale)
        att = R.attr_columns(raw)
        att = torch.where(torch.isfinite(att), att, torch.zeros_like(att))
        self.n_points = xyz.shape[0]
        self.expand_args = (r.offsets, r.counts, r.dkey, r.base, r.h,
                            att.contiguous())
        self.expand_kw = dict(
            total=r.total, tiles_u=self.tiles_x, tile_w=self.tile[0],
            tile_h=self.tile[1], dbits=self.dbits,
            sentinel=((self.num_tiles + 1) << self.dbits) - 1,
            exact_cull=cfg.exact_tile_cull)
        self.keys, self.table, _ = R.build_keys(raw, radius, invalid, camera,
                                                cfg)
        self.tile_ids = (self.keys.fused >> self.dbits).contiguous()
        self.blend_kw = dict(tile=self.tile, tiles_x=self.tiles_x,
                             tiles_y=self.tiles_y)
        self.live_keys = int(self.keys.tile_end[-1])


def walked_pairs(frame: Frame) -> dict:
    """What the blend kernels' work comes to on this frame, counted from
    the plain per-pixel semantics (a pixel walks its tile's keys until
    the one that stops it):
    - pixel: (pixel, key) pairs the blend must evaluate, each pixel's keys
      up to and including the one that stops it (the bound counts these);
    - block: pairs walked when a tile's block runs until its last pixel
      stops (tile pixels x the block's key steps); block_keys: those steps;
    - included: blended (pixel, key) pairs;
    - tile_block_keys: each tile's block key steps (the balance of the
      grid);
    and, for the kernels' warps (``blend.warp_layout``, prefix ``warp``)
    and the first design's rows of 32 pixels (``blend.row_major_warps``,
    prefix ``row_warp``):
    - warp: (pixel, key) pairs walked when a warp of 32 pixels runs until
      its last live pixel stops (32 x the warp's key steps);
    - warp_keys: those warp key steps;
    - warp_keys_kept: the warp key steps that the per-warp rectangle test
      (``blend.rect_key_cull_plain``) cannot cull;
    - warp_keys_included: the warp key steps in which some pixel of the
      warp blends the key (K4 reduces only these)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend

    tw, th = frame.tile
    npx = tw * th
    nw = npx // 32
    dev = frame.table.device
    i = torch.arange(npx, device=dev)
    x = ((i % tw).float() + 0.5)[:, None]
    y = ((i // tw).float() + 0.5)[:, None]
    layouts = {"warp": blend.warp_layout(tw, th, dev),
               "row_warp": blend.row_major_warps(tw, th, dev)}
    out = {k_: 0 for k_ in ("pixel", "block", "block_keys", "included")}
    for pre in layouts:
        out.update({pre: 0, pre + "_keys": 0, pre + "_keys_kept": 0,
                    pre + "_keys_included": 0})
    per_tile = []
    k = frame.keys
    for s, e in zip(k.tile_start.tolist(), k.tile_end.tolist()):
        if e <= s:
            per_tile.append(0)
            continue
        tab = frame.table[:, s:e]
        dx, dy = x - tab[0], y - tab[1]
        alpha = torch.exp(-0.5 * (tab[2] * dx * dx + tab[4] * dy * dy)
                          - tab[3] * dx * dy + tab[5])
        hit = alpha >= blend.ALPHA_SKIP_EPS
        om = 1.0 - torch.where(hit, torch.clamp_max(alpha, blend.ALPHA_CLAMP),
                               torch.zeros_like(alpha))
        p_incl = torch.cumprod(om, 1)
        stop = hit & (p_incl < blend.T_SATURATION_EPS)
        include = hit & (p_incl >= blend.T_SATURATION_EPS)
        first = torch.where(stop.any(1), stop.float().argmax(1) + 1,
                            torch.full_like(stop[:, 0], e - s, dtype=torch.long))
        steps = torch.arange(e - s, device=dev)
        for pre, (pixel, *rects) in layouts.items():
            wfirst = first[pixel].view(nw, 32).max(1).values
            live = steps[None, :] < wfirst[:, None]  # (warps, keys) walked
            kept = blend.rect_key_cull_plain(tab, *rects)
            out[pre + "_keys"] += int(wfirst.sum())
            out[pre + "_keys_kept"] += int((kept & live).sum())
            out[pre + "_keys_included"] += int(
                include[pixel].view(nw, 32, -1).any(1).sum())
        block = int(first.max())
        per_tile.append(block)
        out["pixel"] += int(first.sum())
        out["block_keys"] += block
        out["included"] += int(include.sum())
    for pre in layouts:
        out[pre] = 32 * out[pre + "_keys"]
    out["block"] = npx * out["block_keys"]
    out["tile_block_keys"] = per_tile
    return out


def profile_device(fn, reps: int):
    """torch.profiler over reps calls of fn, after one warm call: (wall ms
    of the window, [(name, device us)]). Only device events (kernels,
    copies, sets) are kept: an aten op's own row repeats the device time
    of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return wall_ms, rows


def device_ms(fn, reps: int) -> float:
    """Device ms of one fn() call: the kernels, copies and sets it runs,
    without the host's time between them."""
    _, rows = profile_device(fn, reps)
    return sum(us for _, us, _ in rows) / 1e3 / reps


def kernel_ms(fn, symbol: str, reps: int) -> float:
    """Device ms of one launch of the CUDA kernel ``symbol`` that fn()
    launches: its events' device time over their count, in a profiler
    window of reps calls."""
    _, rows = profile_device(fn, reps)
    mine = [(us, n) for name, us, n in rows if name.startswith(symbol + "(")]
    if not mine:
        raise AssertionError(f"the profiler saw no {symbol} launch")
    return sum(us for us, _ in mine) / sum(n for _, n in mine) / 1e3


def both_ms(fn, reps: int) -> dict:
    """A call's wall ms (CUDA events over back-to-back calls: the larger of
    the host's and the device's time) beside its device ms."""
    return {"wall_ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps)}


def stage_ms(renderer, q, t) -> dict:
    """Wall and device ms of each stage of one rgb_only frame, each timed
    alone on its own inputs (their sum approximates the frame)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        blend, expand, histogram, tiling,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    s, cam, cfg = renderer.scene, renderer.camera, renderer.rcfg
    tile = R._cfg_tile(cfg)
    reps = 20
    out = {}
    out["attributes (projection, EWA, SH)"] = both_ms(
        lambda: R.compute_raw_attrs(s.xyz, s.features, q, t, cam), reps)
    raw, radius = R.compute_raw_attrs(s.xyz, s.features, q, t, cam)
    cull = lambda: R.frustum_cull_mask(  # noqa: E731
        raw.uv, raw.depth, s.invalid, cam.width, cam.height, cfg.near_plane,
        cfg.far_plane, tile)
    out["frustum cull"] = both_ms(cull, reps)
    visible = cull()
    ranges = lambda: tiling.point_key_ranges(  # noqa: E731
        raw.uv, raw.depth, radius, visible, cam.width, cam.height, tile,
        cfg.depth_to_sort_key_scale)
    out["tile bbox, counts, offsets (+ host sync)"] = both_ms(ranges, reps)
    r = ranges()
    cols = lambda: R.attr_columns(raw)  # noqa: E731
    out["attribute columns"] = both_ms(cols, reps)
    att = cols().contiguous()
    tiles_u = cam.width // tile[0]
    num_tiles = tiles_u * (cam.height // tile[1])
    dbits = tiling._depth_bits(num_tiles)
    exp = lambda: expand.expand_keys(  # noqa: E731
        r.offsets, r.counts, r.dkey, r.base, r.h, att, total=r.total,
        tiles_u=tiles_u, tile_w=tile[0], tile_h=tile[1], dbits=dbits,
        sentinel=((num_tiles + 1) << dbits) - 1, exact_cull=True)
    out["expand_keys (K1)"] = both_ms(exp, reps)
    fused, table = exp()
    out["stable key sort"] = both_ms(lambda: torch.sort(fused, stable=True),
                                     reps)
    fused_s, perm = torch.sort(fused, stable=True)
    out["table gather by the sort permutation"] = both_ms(
        lambda: table.index_select(1, perm), reps)
    table_s = table.index_select(1, perm)

    def ranges_k2():
        hist = histogram.bucket_histogram(fused_s >> dbits, num_tiles)
        return torch.cumsum(hist, 0)
    out["bucket_histogram (K2) + cumsum"] = both_ms(ranges_k2, reps)
    keys, _, _ = R.build_keys(raw, radius, s.invalid, cam, cfg)
    bl = lambda: blend.blend_forward(  # noqa: E731
        table_s, keys.tile_start, keys.tile_end, tile=tile,
        tiles_x=tiles_u, tiles_y=cam.height // tile[1], rgb_only=True)
    out["blend_forward (K3)"] = both_ms(bl, reps)
    tiles = bl()
    out["assemble, clamp, uint8, copy to host"] = both_ms(
        lambda: torch.round(torch.clamp(R._assemble(tiles, cam, cfg).rgb,
                                        0.0, 1.0) * 255).to(torch.uint8).cpu(),
        reps)
    return out


def device_busy(fn, reps: int) -> dict:
    """The device's busy share of a window of reps calls of fn, and the
    device events that take the most of its time."""
    wall_ms, rows = profile_device(fn, reps)
    device_ms_ = sum(us for _, us, _ in rows) / 1e3
    by_name = {}  # names cut to 90 characters; kernels that share one add up
    for name, us, _ in rows:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + us / 1e3 / reps
    top = sorted(by_name.items(), key=lambda r: -r[1])[:10]
    return {"window_ms": wall_ms, "device_busy_ms": device_ms_,
            "busy_share": device_ms_ / wall_ms,
            "top_kernels_ms_per_frame": dict(top)}


# --- phase 1: kernels against their plain versions ------------------------

def check_kernels(frame: Frame, label: str, full_width: bool) -> dict:
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, expand, histogram

    errs = {}
    fused, table = expand.expand_keys(*frame.expand_args, **frame.expand_kw)
    fused_p, table_p = expand.expand_keys_plain(*frame.expand_args,
                                                **frame.expand_kw)
    torch.cuda.synchronize()
    if not (torch.equal(fused, fused_p) and torch.equal(table, table_p)):
        raise AssertionError(f"{label}: expand_keys differs from its plain "
                             f"version (fused {max_abs(fused, fused_p)}, "
                             f"table {max_abs(table, table_p)})")
    errs["expand_keys"] = max(max_abs(fused, fused_p), max_abs(table, table_p))

    ids = frame.tile_ids
    hist = histogram.bucket_histogram(ids, frame.num_tiles)
    hist_p = histogram.bucket_histogram_plain(ids, frame.num_tiles)
    if not torch.equal(hist, hist_p):
        raise AssertionError(f"{label}: bucket_histogram differs")
    errs["bucket_histogram"] = max_abs(hist, hist_p)

    k = frame.keys
    worst = 0.0
    for rgb_only in (True, False):
        got = blend.blend_forward(frame.table, k.tile_start, k.tile_end,
                                  rgb_only=rgb_only, **frame.blend_kw)
        want = blend.blend_forward_plain(frame.table, k.tile_start,
                                         k.tile_end, rgb_only=rgb_only,
                                         **frame.blend_kw)
        torch.cuda.synchronize()
        e_rgb = max_abs(got[..., 0:3], want[..., 0:3])
        e_alpha = max_abs(got[..., 6], want[..., 6])
        depth = lambda o: o[..., 3] / torch.clamp_min(o[..., 4], 1e-6)  # noqa: E731
        e_depth = max_abs(depth(got), depth(want))
        n_count = int((got[..., 5] != want[..., 5]).sum())
        print(f"  {label} blend rgb_only={rgb_only}: max|d rgb| {e_rgb:.3g} "
              f"max|d alpha| {e_alpha:.3g} max|d depth| {e_depth:.3g} "
              f"count differs at {n_count} of {got.shape[0] * got.shape[1]} px")
        if e_rgb > 1e-4 or e_alpha > 1e-4 or e_depth > 5e-4:
            raise AssertionError(f"{label}: blend_forward outside tolerance")
        limit = 1e-4 * got.shape[0] * got.shape[1] if full_width else 0
        if n_count > limit:
            raise AssertionError(f"{label}: blend counts differ at {n_count} px")
        worst = max(worst, e_rgb, e_alpha)
    errs["blend_forward"] = worst
    return errs


# --- phase 1b: the backward kernels against their plain versions ---------

def check_backward_kernels(frame: Frame, label: str, full_width: bool):
    """blend_backward and segment_reduce against their plain versions on
    the frame's keys, a seeded rgb cotangent and the forward's rgb. Returns
    (errors, K4 plain device ms of its one call, the inputs kept for
    timing)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, tiling
    from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr

    k = frame.keys
    cfin = blend.blend_forward(frame.table, k.tile_start, k.tile_end,
                               rgb_only=True, **frame.blend_kw)
    cfin = cfin[..., 0:3].contiguous()
    rng = np.random.default_rng(5)
    g = torch.from_numpy(rng.normal(size=tuple(cfin.shape)).astype(
        np.float32)).to(cfin.device)
    args = (frame.table, k.tile_start, k.tile_end, g, cfin)
    got, img = blend.blend_backward(*args, **frame.blend_kw)
    again, img2 = blend.blend_backward(*args, **frame.blend_kw)
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(img, img2)):
        raise AssertionError(f"{label}: blend_backward does not repeat bit "
                             "for bit")
    # the plain version runs once, timed by CUDA events (it launches tens
    # of kernels a key position: too many events to profile)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want, img_p = blend.blend_backward_plain(*args, **frame.blend_kw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    live = slice(0, frame.live_keys)
    count_diff = got[11, live] != want[11, live]
    n_count = int(count_diff.sum())
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10]
    same = ~count_diff
    excess = ((got[rows] - want[rows]).abs()
              - (5e-4 + 1e-3 * want[rows].abs()))[:, live][:, same]
    e_rows = max_abs(got[rows][:, live][:, same], want[rows][:, live][:, same])
    e_img = max_abs(img, img_p)
    zero_rows = float(got[[9, 12, 13, 14, 15]].abs().max())
    print(f"  {label} blend_backward: max|d row| {e_rows:.3g} (gate "
          f"5e-4 + 1e-3|plain|, worst excess {float(excess.max()):.3g}), "
          f"count differs at {n_count} of {frame.live_keys} keys, "
          f"max|d img| {e_img:.3g}; plain {plain_ms:.3f} ms", flush=True)
    if excess.numel() and float(excess.max()) > 0:
        raise AssertionError(f"{label}: blend_backward outside tolerance")
    if n_count > (1e-4 * frame.live_keys if full_width else 0):
        raise AssertionError(f"{label}: blend_backward counts differ at "
                             f"{n_count} keys")
    if e_img > 1e-4 or zero_rows != 0.0:
        raise AssertionError(f"{label}: blend_backward image or zero rows")
    if float(want[11].sum()) <= 0:
        raise AssertionError(f"{label}: no pixel includes any key")

    d_orig = tiling.regroup_rows_by_slot(got[0:12], k.orig_slot)
    seg = sr.segment_reduce(d_orig, k.offsets, k.counts)
    seg_p = sr.segment_reduce_plain(d_orig, k.offsets, k.counts)
    torch.cuda.synchronize()
    e_seg = max_abs(seg, seg_p)
    # index_add_ adds with atomics on the card, in no fixed order, and the
    # segments' terms cancel: the sum-order bound is 1e-5 of the sum of
    # the terms' magnitudes
    scale = 1 + sr.segment_reduce_plain(d_orig.abs(), k.offsets, k.counts)
    worst = float(((seg - seg_p).abs() / scale).max()) if seg.numel() else 0.0
    print(f"  {label} segment_reduce: max|d| {e_seg:.3g}, worst "
          f"|d| / (1 + sum|terms|) {worst:.3g} (gate 1e-5)", flush=True)
    if worst > 1e-5:
        raise AssertionError(f"{label}: segment_reduce outside tolerance")
    return ({"blend_backward": e_rows, "segment_reduce": e_seg}, plain_ms,
            {"bwd_args": args, "d_orig": d_orig})


# --- phase 4: training --------------------------------------------------------

def train_setup(xyz, feats, camera, cfg_kw):
    """bench.py's train step at full width: the step, a fresh state of the
    scene (numpy arrays through convert.train_state_from_jax) and its
    uint8 target, rendered from the scene with seeded noise (sigma 0.3) on
    the DC colour features (columns 8, 24, 40)."""
    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        train_state_from_jax,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        TrainConfig,
    )

    n = xyz.shape[0]
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(**cfg_kw))
    zeros = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    scene = {"xyz": xyz, "features": feats,
             "invalid": np.zeros((n,), bool),
             "object_id": np.zeros((n,), np.int32)}

    def adam(p):
        return {"mu": np.zeros_like(p), "nu": np.zeros_like(p), "count": 0}
    ctrl = {"num_pixels": zeros(n), "num_in_camera": zeros(n),
            "grad_viewspace": zeros(n), "grad_viewspace_avg": zeros(n),
            "grad_position": zeros(n, 3), "grad_position_norm": zeros(n)}
    state = train_state_from_jax(scene, adam(feats), adam(xyz), ctrl,
                                 device="cuda")
    rng = np.random.default_rng(11)
    feats_gt = feats.copy()
    feats_gt[:, [8, 24, 40]] += rng.normal(0.0, 0.3, (n, 3)).astype(
        np.float32)
    dev = state.scene.xyz.device
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t = torch.zeros(3, device=dev)
    target = R.rasterize(state.scene.xyz, torch.from_numpy(feats_gt).to(dev),
                         state.scene.invalid, q, t, camera,
                         R.RasterizerConfig(rgb_only=True, **cfg_kw)).rgb
    gt = torch.round(torch.clamp(target, 0.0, 1.0) * 255).to(torch.uint8)
    step = trainer.make_train_step(config, camera.height, camera.width,
                                   device="cuda")
    return config, step, state, (gt, q, t, camera.K, 3)


def train_stage_ms(config, state, inputs) -> dict:
    """Wall and device ms of each stage of one train step, each timed
    alone on its own inputs (their sum approximates the step)."""
    import dataclasses

    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        blend, segment_reduce as sr, tiling,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.training import (
        controller, trainer,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.loss import (
        compute_loss,
    )

    gt_u8, q, t, K, band = inputs
    s = state.scene
    cfg = dataclasses.replace(config.rasterisation_config, slim=True)
    cam = R.Camera(K, WIDTH, HEIGHT)
    tile = R._cfg_tile(cfg)
    grid = (WIDTH // tile[0], HEIGHT // tile[1])
    reps = 20
    out = {}
    x = s.xyz.detach().requires_grad_(True)
    f = s.features.detach().requires_grad_(True)

    def attrs():
        with torch.enable_grad():
            return R.compute_raw_attrs(x, f, q, t, cam, band)
    out["attributes (forward, building the graph)"] = both_ms(attrs, reps)
    raw, radius = attrs()
    raw_v = R.RawAttrs(*(a.detach() for a in raw))
    keys_fn = lambda: R.build_keys(raw_v, radius.detach(), s.invalid,  # noqa: E731
                                   cam, cfg)
    out["tiling (cull, keys, K1, sort, gather, K2)"] = both_ms(keys_fn, reps)
    keys, table, visible = keys_fn()
    k3 = lambda: blend.blend_forward(  # noqa: E731
        table, keys.tile_start, keys.tile_end, tile=tile, tiles_x=grid[0],
        tiles_y=grid[1], rgb_only=True)
    out["blend_forward (K3)"] = both_ms(k3, reps)
    out_tiles = k3()
    rgb = R._assemble(out_tiles, cam, cfg).rgb
    gt = gt_u8.to(torch.float32) * (1.0 / 255.0)

    def loss():
        p = torch.clamp(rgb, 0.0, 1.0).requires_grad_(True)
        ff = s.features.detach().requires_grad_(True)
        with torch.enable_grad():
            val = compute_loss(p, gt, config.loss_function_config,
                               features=ff, invalid_mask=s.invalid)[0]
            return torch.autograd.grad(val, (p, ff))
    out["loss (L1 + SSIM + scale reg, value and gradient)"] = both_ms(
        loss, reps)
    d_pred, _ = loss()
    d_tiles = R._image_to_tiles(d_pred, grid[0], grid[1], tile)
    cfin = out_tiles[..., 0:3].contiguous()
    k4 = lambda: blend.blend_backward(  # noqa: E731
        table, keys.tile_start, keys.tile_end, d_tiles, cfin, tile=tile,
        tiles_x=grid[0], tiles_y=grid[1], imggrad=False)
    out["blend_backward (K4)"] = both_ms(k4, reps)
    d_table, _ = k4()
    rows = d_table[0:12]
    regroup = lambda: tiling.regroup_rows_by_slot(rows, keys.orig_slot)  # noqa: E731
    out["regroup by original slot"] = both_ms(regroup, reps)
    d_orig = regroup()
    k5 = lambda: sr.segment_reduce(d_orig, keys.offsets, keys.counts)  # noqa: E731
    out["segment_reduce (K5)"] = both_ms(k5, reps)
    d_raw, (mag, npix, _) = R._blend_bwd_impl(
        raw_v, keys, table, out_tiles, d_tiles, tile, grid, cfg)

    def vjp():
        return torch.autograd.grad(
            (raw.uv, raw.conic, raw.opacity, raw.color), (x, f),
            (d_raw.uv, d_raw.conic, d_raw.opacity, d_raw.color),
            retain_graph=True)
    out["attribute VJP (autograd)"] = both_ms(vjp, reps)
    d_xyz, d_feat = vjp()
    ftx, ptx = trainer.make_optimizers(config)
    gf = torch.from_numpy(trainer.grad_factor_vector(cfg)).to(s.xyz.device)

    def update():
        df = d_feat * gf[None, :]
        valid = ~s.invalid[:, None]
        dx = torch.where(valid, d_xyz, torch.zeros_like(d_xyz))
        df = torch.where(valid, df, torch.zeros_like(df))
        ftx.update(df, state.feat_opt, s.features)
        ptx.update(dx, state.pos_opt, s.xyz)
        controller.accumulate(state.ctrl, visible, npix, mag, dx)
    out["grad factors, two Adams, accumulate"] = both_ms(update, reps)
    return out


def run_training(xyz, feats, camera, cfg_kw, kernels) -> dict:
    """Phase 4: 3 warm-up and 20 timed train steps with the launch counts
    set to 0 before the timed steps and read after them."""
    config, step, state, inputs = train_setup(xyz, feats, camera, cfg_kw)
    losses, finite = [], []

    def one_step():
        nonlocal state
        state, metrics, aux = step(state, *inputs)
        losses.append(metrics["loss"])
        finite.append(torch.isfinite(aux["grad_features"]).all()
                      & torch.isfinite(aux["grad_xyz"]).all()
                      & torch.isfinite(metrics["loss"]))
        return metrics

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    for f in kernels.values():
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    steps = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        metrics = one_step()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    launches = {name: f.launches for name, f in kernels.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_list = [float(v) for v in losses]
    print(f"  {steps} timed steps: {step_ms:.3f} ms/step; losses "
          f"{loss_list[0]:.6f} (first) -> {loss_list[-1]:.6f} (last); "
          f"launches {launches}", flush=True)
    if not all(bool(v) for v in finite):
        raise AssertionError("a non-finite loss or gradient")
    if not loss_list[-1] < loss_list[0]:
        raise AssertionError("the loss did not fall")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the train step never launched {name}")
    for name in ("blend_backward", "segment_reduce"):
        if launches[name] != steps:
            raise AssertionError(f"{name}: {launches[name]} launches in "
                                 f"{steps} steps")
    stages = train_stage_ms(config, state, inputs)
    for name, v in stages.items():
        print(f"  train stage {name}: wall {v['wall_ms']:.4f} ms, device "
              f"{v['device_ms']:.4f} ms", flush=True)
    busy = device_busy(one_step, reps=5)
    print(f"  train profiler: {busy}", flush=True)
    return {"train_ms_per_step": step_ms,
            "train_mpix_s": HEIGHT * WIDTH / 1e6 / (step_ms / 1e3),
            "train_steps_timed": steps, "train_losses": loss_list,
            "train_num_keys": int(metrics["num_keys"]),
            "train_launches": launches,
            "train_launches_per_step": {n: v / steps
                                        for n, v in launches.items()},
            "train_peak_mem_gib": peak_gib, "train_stage_ms": stages,
            "train_device_ms_per_step": busy["device_busy_ms"] / 5,
            "train_profile": busy}


# --- main -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the record here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        blend, cuda_build, expand, histogram, segment_reduce as sr,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    dev = torch.device("cuda")
    R.pin_f32_matmul()
    card = card_line()
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc in parallel: {build_s})", flush=True)
    render_kernels = {"expand_keys": expand.expand_keys,
                      "bucket_histogram": histogram.bucket_histogram,
                      "blend_forward": blend.blend_forward}
    kernels = dict(render_kernels, blend_backward=blend.blend_backward,
                   segment_reduce=sr.segment_reduce)

    # phase 1a: the small frame
    xyz, feats, invalid = small_scene()
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t_id = torch.zeros(3, device=dev)
    K_small = put(np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]],
                             np.float32))
    small = Frame(put(xyz), put(feats), put(invalid), q_id, t_id,
                  R.Camera(K_small, 64, 64), R.RasterizerConfig(tile_size=TILE))
    t_run = time.perf_counter()

    def phase(title):
        print(f"{title} [{time.perf_counter() - t_run:.1f} s]", flush=True)

    phase("phase 1: kernels against their plain versions")
    check_kernels(small, "64x64", full_width=False)
    phase("phase 1b: backward kernels against their plain versions")
    check_backward_kernels(small, "64x64", full_width=False)

    # the full-width scene, through a .ply file as a user would load it
    xyz, feats = truck_scene_surround(N_POINTS)
    K_np = np.asarray([[580.0, 0.0, WIDTH / 2], [0.0, 580.0, HEIGHT / 2],
                       [0.0, 0.0, 1.0]], np.float32)
    pose_list = poses(9)
    with tempfile.TemporaryDirectory() as tmp:
        ply = str(Path(tmp) / "scene.ply")
        scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                                features=feats, device="cpu"),
                         ply)
        renderer = render.GaussianPointRenderer(
            render.RendererConfig(parquet_paths=[ply], image_height=HEIGHT,
                                  image_width=WIDTH, camera_intrinsics=K_np),
            pose_list, device="cuda")
    s = renderer.scene
    full_cfg = R.RasterizerConfig(tile_size=TILE)
    full = Frame(s.xyz, s.features, s.invalid, q_id, t_id, renderer.camera,
                 full_cfg)
    print(f"full-width frame: {N_POINTS} points, {full.expand_kw['total']} "
          f"keys, {full.live_keys} live after the exact cull", flush=True)
    errs = check_kernels(full, f"{WIDTH}x{HEIGHT}", full_width=True)
    bwd_errs, k4_plain_ms, bwd = check_backward_kernels(
        full, f"{WIDTH}x{HEIGHT}", full_width=True)
    errs.update(bwd_errs)

    # phase 2: the main path, with the launch counts read around it
    phase("phase 2: render through GaussianPointRenderer")
    for f in kernels.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = dict(renderer.frames())
    first_pass_s = time.perf_counter() - t0
    launches = {name: f.launches for name, f in render_kernels.items()}
    print(f"  {len(frames)} frames in {first_pass_s:.3f} s (first pass); "
          f"launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"the render path never launched {name}")
    for i, fr in frames.items():
        if fr.shape != (HEIGHT, WIDTH, 3) or fr.dtype != np.uint8:
            raise AssertionError(f"frame {i}: {fr.shape} {fr.dtype}")
        if not fr.any():
            raise AssertionError(f"frame {i} is all zero")
    # one full-output frame against the plain blend of the same keys
    out = R.rasterize(s.xyz, s.features, s.invalid, q_id, t_id,
                      renderer.camera, full_cfg)
    plain = R._assemble(blend.blend_forward_plain(
        full.table, full.keys.tile_start, full.keys.tile_end,
        **full.blend_kw), renderer.camera, full_cfg)
    e = {f: max_abs(getattr(out, f), getattr(plain, f))
         for f in ("rgb", "alpha", "depth")}
    n_count = int((out.count != plain.count).sum())
    print(f"  full-output frame vs plain blend: {e}, count differs at "
          f"{n_count} px", flush=True)
    if (e["rgb"] > 1e-4 or e["alpha"] > 1e-4 or e["depth"] > 5e-4
            or n_count > 1e-4 * HEIGHT * WIDTH):
        raise AssertionError("full-output frame outside tolerance")
    if not bool(torch.isfinite(out.rgb).all()):
        raise AssertionError("non-finite pixels")

    # phase 3: timing, after a warm-up
    phase("phase 3: timing")
    qs, ts = render.se3_to_qt(renderer.poses)
    n_poses = qs.shape[0]
    state = {"i": 0}

    def one_frame():
        i = state["i"] % n_poses
        state["i"] += 1
        renderer.render(qs[i], ts[i])

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(one_frame, reps=45, warmup=9)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    frames = dict(renderer.frames())
    frames_s = time.perf_counter() - t0
    mpix_s = HEIGHT * WIDTH / 1e6 / (frame_ms / 1e3)
    stages = stage_ms(renderer, q_id, t_id)
    busy = device_busy(one_frame, reps=18)
    for name, v in stages.items():
        print(f"  stage {name}: wall {v['wall_ms']:.4f} ms, device "
              f"{v['device_ms']:.4f} ms", flush=True)
    print(f"  profiler: {busy}", flush=True)

    k = full.keys
    rgb_table = full.table
    timed = {
        "expand_keys": (lambda: expand.expand_keys(*full.expand_args,
                                                   **full.expand_kw),
                        lambda: expand.expand_keys_plain(*full.expand_args,
                                                         **full.expand_kw)),
        "bucket_histogram": (
            lambda: histogram.bucket_histogram(full.tile_ids, full.num_tiles),
            lambda: histogram.bucket_histogram_plain(full.tile_ids,
                                                     full.num_tiles)),
        "blend_forward": (
            lambda: blend.blend_forward(rgb_table, k.tile_start, k.tile_end,
                                        rgb_only=True, **full.blend_kw),
            lambda: blend.blend_forward_plain(rgb_table, k.tile_start,
                                              k.tile_end, rgb_only=True,
                                              **full.blend_kw)),
    }
    bwd_args, d_orig = bwd["bwd_args"], bwd["d_orig"]
    timed["blend_backward"] = (
        lambda: blend.blend_backward(*bwd_args, **full.blend_kw), None)
    timed["segment_reduce"] = (
        lambda: sr.segment_reduce(d_orig, k.offsets, k.counts),
        lambda: sr.segment_reduce_plain(d_orig, k.offsets, k.counts))
    # "ms" is the kernel's own device time per launch; "plain_ms" and
    # "library_ms" are device time per call (blend_backward's plain_ms:
    # the wall time of its one call); a call's wall time (host included)
    # is kept beside them in the record
    symbol = {"expand_keys": "expand_kernel",
              "bucket_histogram": "histogram_kernel",
              "blend_forward": "blend_forward_kernel",
              "blend_backward": "blend_backward_kernel",
              "segment_reduce": "segment_reduce_kernel"}
    ms = {n: kernel_ms(kern, symbol[n], reps=50)
          for n, (kern, _) in timed.items()}
    # the blend wrappers also launch the tile-order kernel (heaviest tile
    # first, csrc/tile_order.cuh) before the blend: its own time a call
    order_ms = {n: kernel_ms(timed[n][0], "tile_order_kernel", reps=50)
                for n in ("blend_forward", "blend_backward")}
    call_ms = {n: cuda_ms(kern, reps=50, warmup=5)
               for n, (kern, _) in timed.items()}
    plain_ms = {n: device_ms(p, reps=2 if n == "blend_forward" else 10)
                for n, (_, p) in timed.items() if p is not None}
    plain_ms["blend_backward"] = k4_plain_ms  # its one call in phase 1b
    bincount_ms = device_ms(
        lambda: torch.bincount(full.tile_ids, minlength=full.num_tiles),
        reps=50)
    lengths = k.counts.long()
    segment_reduce_lib_ms = device_ms(
        lambda: torch.segment_reduce(d_orig.T.contiguous(), "sum",
                                     lengths=lengths, axis=0, unsafe=True),
        reps=50)
    library_ms = {"bucket_histogram": bincount_ms,
                  "segment_reduce": segment_reduce_lib_ms}

    # phase 4: the training step, with the launch counts read around its
    # timed steps
    phase("phase 4: train steps at full width")
    train = run_training(xyz, feats, renderer.camera, {"tile_size": TILE},
                         kernels)

    # bounds: each input read once, each output written once, and the
    # operations this frame's data needs, on an H100 SXM
    total, n = full.expand_kw["total"], full.n_points
    walked = walked_pairs(full)
    pairs = walked["pixel"]
    included = int(plain.count.sum())
    print("  walked (pixel, key) pairs: " + ", ".join(
        f"{k_} {v}" for k_, v in walked.items() if k_ != "tile_block_keys"),
        flush=True)
    px = HEIGHT * WIDTH
    n_rows = d_orig.shape[0]
    work = {
        # reads offsets, dkey, base, h (4 x 4 B) and 10 attr rows per point;
        # writes the fused key and 16 table rows per key. Per key: a binary
        # search (2 ops a step) and the cull (~45 flops)
        "expand_keys": (4 * 4 * n + 10 * 4 * n + 17 * 4 * total,
                        total * (2 * math.ceil(math.log2(n)) + 45)),
        # reads every sorted tile id, writes the counts; one add per id
        "bucket_histogram": (4 * total + 4 * full.num_tiles, total),
        # reads 9 table rows of every live key (rgb_only) and the ranges,
        # writes 8 floats a pixel; 16 flops per evaluated (pixel, key) pair
        # (quadratic, exp, test) and 11 more per blended pair
        "blend_forward": (9 * 4 * full.live_keys + 8 * full.num_tiles
                          + 8 * 4 * px, 16 * pairs + 11 * included),
        # reads 9 table rows of every live key, the ranges, the rgb
        # cotangent and the forward's rgb (3 floats a pixel each); writes
        # 11 rows of every live key and 2 floats a pixel. 16 flops per
        # evaluated pair, 45 more per included pair
        "blend_backward": (9 * 4 * full.live_keys + 8 * full.num_tiles
                           + 6 * 4 * px + 11 * 4 * full.live_keys
                           + 2 * 4 * px, 16 * pairs + 45 * included),
        # reads every row lane once and the offsets and counts, writes one
        # float a (row, point); one add per row lane
        "segment_reduce": (4 * n_rows * total + 8 * n + 4 * n_rows * n,
                           n_rows * total),
    }
    source = "taichi_3d_gaussian_splatting_tpu_torch/csrc/{}.cu"
    replaces = {
        "expand_keys": "taichi_3d_gaussian_splatting_tpu/ops/expand.py:318",
        "bucket_histogram":
            "taichi_3d_gaussian_splatting_tpu/ops/histogram.py:78",
        "blend_forward":
            "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:389",
        "blend_backward":
            "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:748",
        "segment_reduce":
            "taichi_3d_gaussian_splatting_tpu/ops/segment_reduce.py:235",
    }
    src = {"expand_keys": "expand", "bucket_histogram": "histogram",
           "blend_forward": "blend", "blend_backward": "blend_backward",
           "segment_reduce": "segment_reduce"}
    rows = []
    for name in kernels:
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source.format(src[name]),
            "replaces": replaces[name], "launches": train["train_launches"][name],
            "launches_per_step": train["train_launches_per_step"][name],
            "launches_per_frame": launches.get(name, 0) / len(pose_list),
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms.get(name),
        })
        if name in order_ms:
            rows[-1]["tile_order_ms"] = order_ms[name]

    record = {
        "card": card, "points": N_POINTS, "image": [WIDTH, HEIGHT],
        "tile": TILE, "frames": len(frames),
        "render_ms_per_frame": frame_ms, "render_mpix_s": mpix_s,
        "render_device_ms_per_frame": busy["device_busy_ms"] / 18,
        "frames_loop_s": frames_s, "keys": total,
        "live_keys": full.live_keys, "blend_pairs": pairs,
        "blended_pairs": included,
        "walked_pairs": {k_: v for k_, v in walked.items()
                         if k_ != "tile_block_keys"},
        "launches_per_frame": {n: launches[n] / len(pose_list)
                               for n in launches},
        "bincount_ms": bincount_ms,
        "segment_reduce_library_ms": segment_reduce_lib_ms,
        "kernel_call_wall_ms": call_ms,
        "render_peak_mem_gib": peak_gib,
        "stage_ms": stages, "profile": busy,
        **train,
        "kernels": rows,
    }
    print(f"render: {frame_ms:.3f} ms/frame, {mpix_s:.1f} Mpix/s; "
          f"{len(frames)} frames to host in {frames_s:.3f} s", flush=True)
    phase("done")
    print(f"train: {train['train_ms_per_step']:.3f} ms/step, "
          f"{train['train_mpix_s']:.1f} Mpix/s, peak "
          f"{train['train_peak_mem_gib']:.2f} GiB", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({k_: record[k_] for k_ in record if k_ != "kernels"}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
