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
   bound on an H100 SXM.

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


def blend_pairs(frame: Frame) -> int:
    """(pixel, key) pairs the blend must evaluate on this frame: each
    pixel's keys up to and including the one that stops it."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend

    tw, th = frame.tile
    i = torch.arange(tw * th, device=frame.table.device)
    x = ((i % tw).float() + 0.5)[:, None]
    y = ((i // tw).float() + 0.5)[:, None]
    pairs = 0
    k = frame.keys
    for s, e in zip(k.tile_start.tolist(), k.tile_end.tolist()):
        if e <= s:
            continue
        tab = frame.table[:, s:e]
        dx, dy = x - tab[0], y - tab[1]
        alpha = torch.exp(-0.5 * (tab[2] * dx * dx + tab[4] * dy * dy)
                          - tab[3] * dx * dy + tab[5])
        hit = alpha >= blend.ALPHA_SKIP_EPS
        om = 1.0 - torch.where(hit, torch.clamp_max(alpha, blend.ALPHA_CLAMP),
                               torch.zeros_like(alpha))
        stop = hit & (torch.cumprod(om, 1) < blend.T_SATURATION_EPS)
        first = torch.where(stop.any(1), stop.float().argmax(1) + 1,
                            torch.full_like(stop[:, 0], e - s, dtype=torch.long))
        pairs += int(first.sum())
    return pairs


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
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return wall_ms, rows


def device_ms(fn, reps: int) -> float:
    """Device ms of one fn() call: the kernels, copies and sets it runs,
    without the host's time between them."""
    _, rows = profile_device(fn, reps)
    return sum(us for _, us in rows) / 1e3 / reps


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
    device_ms_ = sum(us for _, us in rows) / 1e3
    by_name = {}  # names cut to 90 characters; kernels that share one add up
    for name, us in rows:
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
        blend, cuda_build, expand, histogram,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    dev = torch.device("cuda")
    R.pin_f32_matmul()
    card = card_line()
    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    print(f"built {sorted(build_s)} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc in parallel: {build_s})", flush=True)
    kernels = {"expand_keys": expand.expand_keys,
               "bucket_histogram": histogram.bucket_histogram,
               "blend_forward": blend.blend_forward}

    # phase 1a: the small frame
    xyz, feats, invalid = small_scene()
    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t_id = torch.zeros(3, device=dev)
    K_small = put(np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]],
                             np.float32))
    small = Frame(put(xyz), put(feats), put(invalid), q_id, t_id,
                  R.Camera(K_small, 64, 64), R.RasterizerConfig(tile_size=TILE))
    print("phase 1: kernels against their plain versions", flush=True)
    check_kernels(small, "64x64", full_width=False)

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

    # phase 2: the main path, with the launch counts read around it
    print("phase 2: render through GaussianPointRenderer", flush=True)
    for f in kernels.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = dict(renderer.frames())
    first_pass_s = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
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
    print("phase 3: timing", flush=True)
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
    # "ms", "plain_ms" and "library_ms" are device time per call; a call's
    # wall time (host included) is kept beside them in the record
    ms = {n: device_ms(kern, reps=50) for n, (kern, _) in timed.items()}
    call_ms = {n: cuda_ms(kern, reps=50, warmup=5)
               for n, (kern, _) in timed.items()}
    plain_ms = {n: device_ms(p, reps=2 if n == "blend_forward" else 10)
                for n, (_, p) in timed.items()}
    bincount_ms = device_ms(
        lambda: torch.bincount(full.tile_ids, minlength=full.num_tiles),
        reps=50)

    # bounds: each input read once, each output written once, and the
    # operations this frame's data needs, on an H100 SXM
    total, n = full.expand_kw["total"], full.n_points
    pairs = blend_pairs(full)
    included = int(plain.count.sum())
    px = HEIGHT * WIDTH
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
    }
    source = "taichi_3d_gaussian_splatting_tpu_torch/csrc/{}.cu"
    replaces = {
        "expand_keys": "taichi_3d_gaussian_splatting_tpu/ops/expand.py:318",
        "bucket_histogram":
            "taichi_3d_gaussian_splatting_tpu/ops/histogram.py:78",
        "blend_forward":
            "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:389",
    }
    src = {"expand_keys": "expand", "bucket_histogram": "histogram",
           "blend_forward": "blend"}
    rows = []
    for name in kernels:
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source.format(src[name]),
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": bincount_ms if name == "bucket_histogram" else None,
        })

    record = {
        "card": card, "points": N_POINTS, "image": [WIDTH, HEIGHT],
        "tile": TILE, "frames": len(frames),
        "render_ms_per_frame": frame_ms, "render_mpix_s": mpix_s,
        "frames_loop_s": frames_s, "keys": total,
        "live_keys": full.live_keys, "blend_pairs": pairs,
        "blended_pairs": included,
        "launches_per_frame": {n: launches[n] / len(pose_list)
                               for n in launches},
        "bincount_ms": bincount_ms, "kernel_call_wall_ms": call_ms,
        "render_peak_mem_gib": peak_gib,
        "stage_ms": stages, "profile": busy,
        "kernels": rows,
    }
    print(f"render: {frame_ms:.3f} ms/frame, {mpix_s:.1f} Mpix/s; "
          f"{len(frames)} frames to host in {frames_s:.3f} s", flush=True)
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
