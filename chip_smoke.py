#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out record.json]

Builds the port's CUDA kernels from ``taichi_3d_gaussian_splatting_tpu_torch/
csrc`` with nvcc (sm_90a, one nvcc per source, all at once), and beside
them the first design of K1 and K5 from ``kernel_variants/`` (the
yardstick of their redesign), then:

1. holds each kernel against its plain PyTorch version on the card, on the
   same inputs: a small frame (64x64, 200 points) and the full-width frame
   (428,687 points, 960x544, 32x32 tiles). The key expansion's two passes
   (slot_keys: fused keys and owners; sorted_table: the table after the
   sort), tile_ranges (the tile ranges of the sorted keys) and
   tile_counts (the tile counters of those ranges) must match
   bit for bit, tile_ranges also against torch.searchsorted, and the fused
   keys,
   the sort's permutation and the sorted table must equal the first
   design's keys and its pre-sort table gathered by the permutation;
   blend_forward within 1e-4 (rgb, alpha) and 5e-4 (depth), with the count
   exact at the small size and differing on under 0.01% of the full-width
   pixels (the gate as it was set; on an H100 80GB HBM3 the kernel and its
   plain version agree on every full-width pixel, and a float64
   sequential blend differs from both on 1 of the 522,240: f32 rounding
   at a threshold, a fault of neither side);
2. renders 9 full-width frames through ``apps/render.py``'s
   GaussianPointRenderer (the user's entry point; the scene goes through a
   .ply file), as the JAX renderer does: the key capacity fitted to the
   poses (``fit_key_cap``, headroom 1.15), each frame one CUDA graph
   replay at that capacity. Every kernel's launch count is set to 0
   before and read after, and the first design's data movement (the table
   gather, the regroup) counted and held at 0. Checks one capture, K1a (in
   its capped mode), K1b, K2 and K3 launched at the graph's warm-up and
   capture alone and once a replay in a profiler trace of replays, every
   replayed frame bit for bit the exact eager frame (keys sized to the
   frame's total) and the capped eager frame, no frame past the capacity,
   the frames, and one full-output frame against the plain blend;
3. times the graph frame and the exact eager frame with CUDA events after
   a warm-up, each stage's wall
   and device time, and each kernel's device time (torch.profiler) beside
   its plain version's, its library call's (torch.searchsorted for K2's
   tile_ranges; for K5 the chain index_copy_ + torch.segment_reduce) and
   the kernel's bound on an H100 SXM. A device time is read only from a
   profiler window that shows the call's own kernels (``profiled``: three
   windows without them fail the run); times the first design's stages around K1 and K5
   (``kernel_variants/keys_step0.py``: its K1, the sort, the table gather,
   the regroup, its K5); counts the (pixel, key) pairs the blend kernels
   walk per pixel, per warp and per block,
   and the warp key steps their per-warp cull keeps (``walked_pairs``);
1b. (run after 1) holds the backward kernels against their plain versions
   at both sizes, with a seeded image cotangent and the forward's own rgb:
   blend_backward's rows within 5e-4 + 1e-3 |plain| (the JAX package's
   gradient gate), its count exact at 64x64 and differing on under 0.01%
   of the full-width keys (as K3's: on an H100 the two agree on every key,
   and the float64 blend differs from both on 1 of 433,512), its |grad_uv|
   image within 1e-4, and two runs
   bit-identical; segment_reduce (through the inverse key permutation) bit
   for bit against its plain version and the first design's regroup +
   kernel;
4. trains at full width through ``training/trainer.py``'s make_train_step
   (bench.py's train step: TrainConfig defaults, SH degree 3): 3 warm-up
   and 20 timed steps from a state made by ``convert.train_state_from_jax``
   of numpy arrays, towards a uint8 target rendered from the same scene
   with seeded noise on its DC colours. Checks every loss and gradient
   finite, the loss falling, every kernel launched once a timed step, and
   no table gather or regroup; times the step, its stages and the
   device's busy share;
5. trains through the loop, ``GaussianPointCloudTrainer.train()`` (the
   entry point of ``apps/train.py``), built by ``config.from_dict`` and a
   subclass that serves in-memory views and writes the scene as .parquet
   (.ply where pandas or its parquet engine is missing): the phase-4 scene
   in a pool of 1.25x its points (535,858 slots), 6 train and 2 val views
   at 960x544 rendered from a second seeded scene and quantized to 8 bits
   like a PNG decode; 40 iterations, downsample factor 2 for the first 20,
   SH bands 0-3, warm-up 10, densify every 10 with thresholds that fill
   free slots, an alpha reset at 25, a validation at 20. Counts every
   kernel's launches over the run (and no plain version), times the
   whole train() window an iteration, the plain iterations at each size against phase 4's step, a densify round,
   a validation frame and the checkpoint save, prints num_valid around
   each round, and resumes a fresh trainer from ``checkpoint_latest``,
   holding its state equal to the state that was saved;
6. trains with pose refinement through make_train_step (pose_refinement,
   pose_refinement_warm_up 2) on the phase-4 scene: 3 views whose targets
   are rendered at ``poses(3)`` and whose poses are perturbed by a seeded
   rotation (up to 0.01 rad an axis) and shift (up to 2 cm); 3 warm-up
   steps (the first 2 with view index -1) and 20 timed ones. Checks every
   kernel once a timed step, the loss, the pose cotangents and deltas
   finite, the deltas zero through the warm-up and moving after it, and
   one step's se(3) pose cotangent against the plain route's (every
   kernel wrapper swapped for its plain version, ``plain_route``) within
   1e-3 of its norm; times the step and its device share;
7. serves ``apps/visualizer.py``'s viewer at 992x544 over two objects (the
   phase-4 scene and a seeded one of 200,000 points, as .ply files) on a
   free port, posts 10 events (select, move, spin, hide, show, camera
   moves) and reads a frame after each (JPEG from /frame, or through
   ``render_frame`` where PIL is missing). Checks the frames change with
   the events, K1-K3 once a frame, a frame with distinct object poses
   against the plain route (rgb 1e-4) and one with equal poses bit for bit
   against the single-pose render; prints the median frame latency;
8. renders from a dataset .json (``render.poses_from_dataset``, three
   960x544 PNG views, or items served from memory where PIL is missing)
   with rgb_only and pack_sort_colors: one graph, K1-K3 at its warm-up
   and capture, the table's r
   and g rows equal to round_bf16 of the unpacked rows and the rest equal,
   K3 on the packed table against the plain blend (rgb 1e-4);
9. runs ``tools/ftgmm.ft_grab_scene`` once on the loop's final scene:
   finite metrics, and its time;
10. trains through ``parallel/data_parallel.py``'s step at full width (the
   phase-4 scene and target), each rank a process of its own
   (``multihost.run_local_ranks``): (a) a group of one over NCCL, one step
   bit for bit the single-device step from the same state; (b) two ranks
   over gloo (they share the card, and NCCL refuses two ranks on one
   device) on the same view, 3 steps within the gradient gate (5e-4 +
   1e-3 |single|) of 3 single-device steps and the two ranks' states
   bit-identical; (c) the two ranks on views 0 and 1 of ``poses()``: ms a
   step (CUDA events; two ranks sharing one card measure sharing, not
   scaling), the step's collectives timed alone and their share, every
   kernel once a step on each rank;
11. one ``parallel/tile_parallel.py`` step at 1920x1088 (Truck's frame
   cropped to 32-px tiles; two bands of 17 tile rows) on the two ranks:
   its gradients and Adam moments within the gradient gate of the
   single-device step at that size, its frame within 1e-4, the ranks'
   states bit-identical, each band's key total, then ms a step and every
   kernel once a step on each rank;
12. ``apps/render.py``'s renderer on the two ranks over the 9 poses at
   960x544: ``data_parallel`` (rank r renders poses r, r + 2, ...) whose
   uint8 frames equal phase 2's bit for bit (each rank one graph, K1-K3
   at its warm-up and capture), and ``tile_parallel`` (576 rows rendered
   in two bands, cropped to 544, keys sized exactly) whose float frames
   hold the image gate against the single-device render (rgb, alpha 1e-4,
   depth 5e-4, counts but 0.01% of pixels), K1-K3 once a frame a rank;
13. ``parallel/mh_smoke.py``'s worker on two ranks (4 cameras a rank)
   against ``single_process_reference`` (one process, 8 cameras): losses
   at rtol 1e-5, Adam's first moments at the gradient gate, the visibility
   counts exact, and the launches of 2 steps of 4 cameras a rank;
14. trains in windows of 8 steps through make_train_step(scan_steps=8),
   each window one CUDA graph replay: (a) from phase 4's start state over
   8 views (targets rendered at ``poses(8)`` as phase 10's), with the key
   capacity fitted to their totals, the window's state and 8 losses equal
   bit for bit to 8 eager steps on the exact path, replayed twice, and
   tile_counts launched once a step in the capture (a render graph
   launches it never, phase 2); (b)
   with a capacity below the full-width total (2^18 against 471,633
   keys), K1a in its capped mode bit for bit against its capped plain
   version (and at the fitted capacity), and the capped step against the
   capped plain route: loss at rtol 1e-4, the frame within 1e-4, the
   gradients within 5e-4 + 1e-3 |plain|, the true key total reported;
   (c) ms a step over warm replays (CUDA events), the device's busy share,
   the capture time, the graph pool's memory, and each kernel's launches a
   window counted from the profiler's trace of replays (8 each; the
   wrappers' counters do not tick under a replay), and the tile counters
   those replays recorded (``stages.read().counts``); (d) phase 5's loop with
   steps_per_dispatch 8: its windows, one capture a (size, SH band,
   capacity) and one graph held at a time, the key-capacity refits, ms an
   iteration over the whole train() window, and a resume; (e) a 49-
   iteration loop whose windows replay their cached graph after a densify
   round and after an SH-band change (which releases the band's graph and
   captures the next), then change size: the graphs held, and the memory
   held before and after each window, which must not grow by a graph
   across the band change, and the peak;
15. trains in windows of data-parallel steps through
   ``parallel/data_parallel.py``'s make_dp_train_step(scan_steps), in the
   rank processes of phases 10-12 after their own work (a process costs
   seconds to reach the card), checked after phase 14: (a) the group of
   one over NCCL, the phase-4
   scene and start state over phase 14's 8 views (f32 targets, one row a
   step) at phase 14a's fitted capacity: one CUDA graph a window holding
   its collectives, its state and 8 losses bit for bit those of phase
   14a's single-device window and of 8 eager capped data-parallel steps,
   replayed twice; ms a step over warm replays, busy share, capture time,
   pool memory, every kernel's launches and NCCL's kernels from the
   profiler's trace of replays, and phase 10a's eager step timed beside
   it; (b) two gloo ranks sharing the card, a window of 4 steps on views
   (2s, 2s + 1) of ``poses(8)``: eager (gloo copies through the host, which
   no graph can hold), a second window timed warm, the ranks
   bit-identical, losses at rtol 1e-5 and
   the state within the gradient gate of 4 steps of the group-of-one step
   on both rows, every kernel once a step on each rank; (c) phase 14d's
   loop with ``multihost`` in the group of one over NCCL (windows,
   captures, one graph held, the refit, ms an iteration, the resume), and
   a 20-iteration cut of it with ``data_parallel_devices: 2`` on the two
   gloo ranks, whose final states are bit-identical; (d) the release, last
   in the NCCL group of one, with 15a's window kept alive through (c): the
   windows ``multihost`` tracks hold it, ``multihost.shutdown()`` releases
   every one before the group goes (nothing in the phase releases one),
   and the card's reserved memory falls by at least what 15a's window
   held. The memory of 14e is read without the cyclic collector: a
   window the trainer drops frees its graph at once;
16. runs the synthetic quality gate, ``tools/quality_run.py`` (the port's
   ``scripts/quality_run.py``), in its default preset and in full: the
   procedural GT scene (16,000 Gaussians) rendered on the card into 48
   views at 256 px, written by the tool as PNGs, ``train.json``/``val.json``
   and a .parquet of 2,000 noisy init points in a pool of 40,000, and 2001
   iterations of the stock ``GaussianPointCloudTrainer.train()`` on those
   files in windows of 10 steps, each a CUDA graph, into a temporary
   directory. Prints the best val PSNR beside the JAX package's
   27.07-27.222 on a TPU v5e (RESULTS.md), the final valid points beside
   its 40,000, the val PSNR at each validation, the seconds and it/s
   beside the TPU's 1.3 it/s, the windows, captures, replays and graphs
   held (the tool's record), the key-capacity refits, and each kernel's
   launches as the wrappers count them (eager steps, validation frames,
   each graph's warm-up and capture; replays do not tick them).
   Fails if the best val PSNR is outside [26.57, 27.72] (0.5 dB from the
   JAX band), the final valid points are under 36,000, a plain version
   ran, a kernel never launched, a loss was not finite, or a window held
   other than one graph;
17. runs ``tools/inference_benchmark.py`` (the port of
   ``benchmark/inference_benchmark.py``) in the reference protocol, 1000
   warm-up and 100 timed frames, on the phase-4 scene as a .ply over a
   dataset .json of 8 PNG views at 960x544 (written as phase 8's): the
   capacity fitted over the views (headroom 1.1), one CUDA graph a (H, W)
   bucket. Fails unless there is one graph, K1a (capped mode), K1b, K2
   and K3 launched at its warm-up and capture with no plain call, no
   frame passed the capacity, and every view's replayed frame is the
   exact eager frame bit for bit; prints ms (host clock and CUDA events),
   FPS and Mpix/s beside the card; then runs
   ``tools/profile_attribution.py --rgb-only --fit-cap`` and prints its
   device time by stage and its top kernels.

Each path's launch counts are set to 0 just before it and read just after
(in phases 10-13 and 15 by each rank, in its own process; in phase 16
around the gate's ``train()``; in phase 17 around the benchmark's
frames). A graph's replays do not tick the counters: its warm-up and
capture do, and a profiler trace of replays counts the launches there.
In phases 1 and 1b a float64 sequential front-to-back blend of every
tile's sorted keys (``f64_counts``) gives each pixel's and each key's
count; ``count_check`` in the record says on how many the kernel (K3's
per-pixel, K4's per-key count) and its plain version differ from it.

The scene is a seeded copy of bench.py's surround scene (random weights).
Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Any failure raises, so the process
exits non-zero; without a CUDA card it exits 1 before doing anything.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import tempfile
import threading
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


def zero_launches(kernels) -> None:
    """Set every kernel's launch count to 0."""
    for f in kernels.values():
        f.launches = 0


def read_launches(kernels) -> dict:
    """{name: launch count} of the kernels."""
    return {name: f.launches for name, f in kernels.items()}


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
        self.attr_args = (xyz, feats, q, t, camera.K)
        visible = R.frustum_cull_mask(
            raw.uv, raw.depth, invalid, camera.width, camera.height,
            cfg.near_plane, cfg.far_plane, self.tile)
        r = tiling.point_key_ranges(raw.uv, raw.depth, radius, visible,
                                    camera.width, camera.height, self.tile,
                                    cfg.depth_to_sort_key_scale)
        # finite, as the first design's K1 needs them (the kernels read
        # non-finite entries as 0)
        att = torch.nan_to_num(R.attr_columns(raw), 0.0, 0.0, 0.0)
        self.n_points = xyz.shape[0]
        self.expand_args = (r.offsets, r.counts, r.dkey, r.base, r.h, att)
        self.expand_kw = dict(
            total=r.total, tiles_u=self.tiles_x, tile_w=self.tile[0],
            tile_h=self.tile[1], dbits=self.dbits,
            sentinel=((self.num_tiles + 1) << self.dbits) - 1,
            exact_cull=cfg.exact_tile_cull)
        self.table_kw = {k: self.expand_kw[k] for k in (
            "tiles_u", "tile_w", "tile_h", "dbits", "sentinel")}
        self.keys, self.table, _ = R.build_keys(raw, radius, invalid, camera,
                                                cfg)
        self.tile_ids = (self.keys.fused >> self.dbits).contiguous()
        self.blend_kw = dict(tile=self.tile, tiles_x=self.tiles_x,
                             tiles_y=self.tiles_y)
        self.live_keys = int(self.keys.tile_end[-1])


def small_frame(dev) -> Frame:
    """The 64x64 frame of ``small_scene`` from the identity pose."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xyz, feats, invalid = small_scene()
    K = put(np.asarray([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32))
    return Frame(put(xyz), put(feats), put(invalid),
                 torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
                 torch.zeros(3, device=dev), R.Camera(K, 64, 64),
                 R.RasterizerConfig(tile_size=TILE))


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


def _guard():
    """A spin kernel, a sync and a short wait: the profiler loses device
    events at the edges of a window now and then, and these guard the
    timed calls at both ends (the spin's row is dropped)."""
    torch.cuda._sleep(100_000)  # ~0.05 ms of the device
    torch.cuda.synchronize()
    time.sleep(0.01)


def profile_device(fn, reps: int):
    """torch.profiler over reps calls of fn, after one warm call: (wall ms
    of the calls, [(name, device us, count)]). Only device events
    (kernels, copies, sets) are kept: an aten op's own row repeats the
    device time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _guard()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        _guard()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and SPIN not in e.key]
    return wall_ms, rows


SPIN = "spin_kernel"  # torch.cuda._sleep's kernel
LOSS = 0.1  # the share of a name's events a window may lose
# windows taken, windows taken again, device events the kept windows lost
WINDOWS = {"taken": 0, "retaken": 0, "events_lost": 0}


def per_call(rows, reps: int, expect: tuple):
    """A window's rows as ([(name, device us a call, launches a call)],
    events the window lost), or None if it lost more than LOSS of the
    events of a name that holds a string of ``expect``.

    A name's launches a call is its count over reps, rounded (k). A name
    whose count is a little short of k a call (by at most LOSS) lost some
    events: its time a call is the mean of the events the window kept
    times k. An expected name (one every call launches a whole number of
    times) with any other count fails the window; any other name (a copy
    or a set whose count may depend on the data, or one that not every
    call launches) counts as it stands."""
    out, lost = [], 0
    for name, us, n in rows:
        k = round(n / reps)
        if k >= 1 and (1 - LOSS) * k * reps <= n <= k * reps:
            out.append((name, us / n * k, k))
            lost += k * reps - n
        elif k >= 1 and any(e in name for e in expect):
            return None
        else:
            out.append((name, us / reps, n / reps))
    return out, lost


def profiled(fn, reps: int, expect: tuple):
    """profile_device over reps calls of fn: (wall ms, per_call rows) of a
    window in which each string of expect is part of the name of an event
    every call launches. The profiler now and then loses a few of a call's
    events: a window that lost at most LOSS of each expected name's is
    read as ``per_call`` says, one that lost more is taken again, and a
    third such window fails the run."""
    for attempt in range(3):
        WINDOWS["taken"] += 1
        WINDOWS["retaken"] += attempt > 0
        wall_ms, rows = profile_device(fn, reps)
        read = per_call(rows, reps, expect)
        if read is not None and all(
                sum(k for name, _, k in read[0] if e in name) >= 1
                for e in expect):
            WINDOWS["events_lost"] += read[1]
            return wall_ms, read[0]
    held = sorted({f"{name[:70]} x{n}" for name, _, n in rows})
    raise AssertionError(f"three profiler windows of {reps} calls lacked some "
                         f"of {expect} or lost over {LOSS:.0%} of a name's "
                         f"events; the last held {held}")


# parts of the names of device events that a timed call must show: a
# plain-torch elementwise op's kernel, and torch.sort's
EW = ("elementwise_kernel",)
SORT = ("RadixSort",)


def device_ms(fn, reps: int, expect: tuple) -> float:
    """Device ms of one fn() call: the kernels, copies and sets it runs,
    without the host's time between them. ``expect``: parts of the names
    of device events the call must show (see ``profiled``)."""
    _, calls = profiled(fn, reps, expect)
    return sum(us for _, us, _ in calls) / 1e3


def kernel_ms(fn, symbol: str, reps: int) -> float:
    """Device ms of one launch of the CUDA kernel ``symbol`` that fn()
    launches: its device time a call over its launches a call, in a
    profiler window of reps calls."""
    _, calls = profiled(fn, reps, (symbol + "(",))
    mine = [(us, k) for name, us, k in calls if symbol + "(" in name]
    return sum(us for us, _ in mine) / sum(k for _, k in mine) / 1e3


def both_ms(fn, reps: int, expect: tuple) -> dict:
    """A call's wall ms (CUDA events over back-to-back calls: the larger of
    the host's and the device's time) beside its device ms."""
    return {"wall_ms": cuda_ms(fn, reps),
            "device_ms": device_ms(fn, reps, expect)}


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
        lambda: R.compute_raw_attrs(s.xyz, s.features, q, t, cam), reps,
        ("point_attributes_kernel",))
    raw, radius = R.compute_raw_attrs(s.xyz, s.features, q, t, cam)
    cull = lambda: R.frustum_cull_mask(  # noqa: E731
        raw.uv, raw.depth, s.invalid, cam.width, cam.height, cfg.near_plane,
        cfg.far_plane, tile)
    out["frustum cull"] = both_ms(cull, reps, EW)
    visible = cull()
    ranges = lambda: tiling.point_key_ranges(  # noqa: E731
        raw.uv, raw.depth, radius, visible, cam.width, cam.height, tile,
        cfg.depth_to_sort_key_scale)
    out["tile bbox, counts, offsets (+ host sync)"] = both_ms(
        ranges, reps, EW + ("Memcpy DtoH",))
    r = ranges()
    cols = lambda: R.attr_columns(raw)  # noqa: E731
    out["attribute columns"] = both_ms(cols, reps, EW)
    att = cols()
    tiles_u = cam.width // tile[0]
    num_tiles = tiles_u * (cam.height // tile[1])
    dbits = tiling._depth_bits(num_tiles)
    tkw = dict(tiles_u=tiles_u, tile_w=tile[0], tile_h=tile[1], dbits=dbits,
               sentinel=((num_tiles + 1) << dbits) - 1)
    k1a = lambda: expand.slot_keys(  # noqa: E731
        r.offsets, r.counts, r.dkey, r.base, r.h, att, total=r.total,
        exact_cull=True, **tkw)
    out["slot keys (K1a)"] = both_ms(k1a, reps, ("slot_keys_kernel(",))
    fused, owner = k1a()
    out["stable key sort"] = both_ms(lambda: torch.sort(fused, stable=True),
                                     reps, SORT)
    fused_s, perm = torch.sort(fused, stable=True)
    k1b = lambda: expand.sorted_table(fused_s, perm, owner, att, **tkw)  # noqa: E731
    out["sorted table (K1b)"] = both_ms(k1b, reps,
                                        ("sorted_table_kernel(",))
    table_s = k1b()

    out["tile_ranges (K2)"] = both_ms(
        lambda: histogram.tile_ranges(fused_s, dbits, num_tiles), reps,
        ("tile_ranges_kernel(",))
    keys, _, _ = R.build_keys(raw, radius, s.invalid, cam, cfg)
    bl = lambda: blend.blend_forward(  # noqa: E731
        table_s, keys.tile_start, keys.tile_end, tile=tile,
        tiles_x=tiles_u, tiles_y=cam.height // tile[1], rgb_only=True)
    out["blend_forward (K3)"] = both_ms(bl, reps, ("blend_forward_kernel(",))
    tiles = bl()
    out["assemble, clamp, uint8, copy to host"] = both_ms(
        lambda: torch.round(torch.clamp(R._assemble(tiles, cam, cfg).rgb,
                                        0.0, 1.0) * 255).to(torch.uint8).cpu(),
        reps, EW + ("Memcpy DtoH",))
    return out


RENDER_SYMBOLS = ("expand_keys", "tile_ranges", "blend_forward")


def replay_launches(fn, reps: int) -> dict:
    """Each render kernel's launches a call of ``fn`` (graph replays: the
    wrappers' counters do not tick), from a profiler window of reps
    calls; K1 counts its two kernels' launches."""
    syms = {n: WINDOW_SYMBOLS[n] for n in RENDER_SYMBOLS}
    _, calls = profiled(fn, reps, tuple(x + "(" for v in syms.values()
                                        for x in v))
    return {n: sum(k for ev, _, k in calls
                   if any(x + "(" in ev for x in v)) for n, v in syms.items()}


def graph_frames(renderer, launches: dict, capped: int) -> dict:
    """Phase 2's checks of the renderer's graph frame: one capture; K1a
    (in its capped mode), K1b, K2 and K3 launched at its warm-up and
    capture alone (``launches``, ``capped``: the counters over
    ``frames()``); every pose's replayed frame bit for bit the exact eager
    frame (no key capacity) and the capped eager frame; each kernel once a
    replay in a profiler window of replays; no frame past the capacity."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps.render import se3_to_qt
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    if renderer.captures != 1 or renderer.graph is None:
        raise AssertionError(f"{renderer.captures} captures")
    if any(n != 2 for n in launches.values()) or capped != 2:
        raise AssertionError(f"graph frame launches {launches}, capped K1a "
                             f"{capped}: expected 2 each (warm-up, capture)")
    s = renderer.scene
    qs, ts = se3_to_qt(renderer.poses)
    n = qs.shape[0]
    unequal = []
    for i in range(n):
        got = renderer.render(qs[i], ts[i])
        exact = torch.clamp(R.rasterize(
            s.xyz, s.features, s.invalid, qs[i], ts[i], renderer.camera,
            renderer.rcfg, sh_max_band=3, point_object_id=s.object_id).rgb,
            0.0, 1.0)
        eager, _ = renderer.render_capped(qs[i], ts[i])
        if not (torch.equal(got, exact) and torch.equal(got, eager)):
            unequal.append(i)
    state = {"i": 0}

    def replay():
        i = state["i"] % n
        state["i"] += 1
        renderer.graph(qs[i], ts[i])
    per_replay = replay_launches(replay, n)
    over = renderer.report_over_cap()
    want = {"expand_keys": 2, "tile_ranges": 1, "blend_forward": 1}
    print(f"  graph frame: key_cap {renderer.key_cap}, {renderer.captures} "
          f"capture ({renderer.graph.capture_s:.3f} s); {n - len(unequal)} "
          f"of {n} replayed frames bit for bit the exact eager frame; "
          f"launches a replay (trace) {per_replay}; frames past the "
          f"capacity {over}", flush=True)
    if unequal or per_replay != want or over:
        raise AssertionError(f"graph frames {unequal} differ, launches a "
                             f"replay {per_replay}, {over} past capacity")
    return {"render_key_cap": renderer.key_cap,
            "render_graph_capture_s": renderer.graph.capture_s,
            "render_launches_per_replay": per_replay,
            "render_graph_launches": dict(launches, capped_slot_keys=capped)}


@contextlib.contextmanager
def first_design_calls():
    """Counts, while open, what the first design ran around K1 and K5 and
    this one must not: a (16, total) table's index_select along its keys
    (the gather after the sort), ``tiling.regroup_rows_by_slot`` and
    segment_reduce on pre-sort rows."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

    calls = {"table index_select": 0, "regroup_rows_by_slot": 0}
    regroup = tiling.regroup_rows_by_slot
    selects = (torch.Tensor.index_select, torch.index_select)

    def count_regroup(*a, **kw):
        calls["regroup_rows_by_slot"] += 1
        return regroup(*a, **kw)

    def counted(select):
        def index_select(t, dim, index, *a, **kw):
            if t.dim() == 2 and t.shape[0] == 16 and dim in (1, -1):
                calls["table index_select"] += 1
            return select(t, dim, index, *a, **kw)
        return index_select

    before = sr.segment_reduce.launches
    tiling.regroup_rows_by_slot = count_regroup
    torch.Tensor.index_select = counted(selects[0])
    torch.index_select = counted(selects[1])
    try:
        yield calls
    finally:
        tiling.regroup_rows_by_slot = regroup
        torch.Tensor.index_select, torch.index_select = selects
        calls["segment_reduce on pre-sort rows"] = (sr.segment_reduce.launches
                                                    - before)


def device_busy(fn, reps: int, expect: tuple) -> dict:
    """The device's busy share of a window of reps calls of fn, and the
    device events that take the most of its time (``profiled``)."""
    wall_ms, calls = profiled(fn, reps, expect)
    device_ms_ = sum(us for _, us, _ in calls) * reps / 1e3
    by_name = {}  # names cut to 90 characters; kernels that share one add up
    for name, us, _ in calls:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda r: -r[1])[:10]
    return {"window_ms": wall_ms, "device_busy_ms": device_ms_,
            "busy_share": device_ms_ / wall_ms,
            "top_kernels_ms_per_frame": dict(top)}


# --- the count check: which side a float64 sequential blend agrees with ----

# the kernels' f32 thresholds, as float64 numbers
ALPHA_SKIP_F32 = float(np.float32(1.0) / np.float32(255.0))
ALPHA_CLAMP_F32 = float(np.float32(0.99))
T_SAT_F32 = float(np.float32(1e-4))
# per label: how many pixels (K3) or keys (K4) have a count other than the
# float64 blend's, for the kernel and for its plain version
COUNT_CHECK = {}


def f64_counts(frame: Frame):
    """A float64 sequential front-to-back blend of every tile's sorted keys
    (``frame.table``'s rows u, v, conic a, b, c, logro), key by key, every
    tile and pixel at once, with the kernels' thresholds (skip alpha <
    1/255, clamp at 0.99, stop where T (1 - a) < 1e-4): (count of keys each
    pixel blends (tiles, px), count of pixels that blend each key (cap,)).
    The stopping key is not blended, as in the kernels."""
    k = frame.keys
    dev = frame.table.device
    tw, th = frame.tile
    i = torch.arange(tw * th, device=dev)
    x = ((i % tw).double() + 0.5)[None, :]
    y = (torch.div(i, tw, rounding_mode="floor").double() + 0.5)[None, :]
    start = k.tile_start.long()
    n = torch.clamp_min(k.tile_end.long() - start, 0)
    cap = frame.table.shape[1]
    tab = frame.table[0:6].double()
    shape = (frame.num_tiles, tw * th)
    T = torch.ones(shape, dtype=torch.float64, device=dev)
    live = torch.ones(shape, dtype=torch.bool, device=dev)
    count = torch.zeros(shape, dtype=torch.int64, device=dev)
    per_key = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    for j in range(int(n.max()) if frame.num_tiles else 0):
        if j % 64 == 0 and not bool((live & (n[:, None] > j)).any()):
            break
        has = n > j
        col = torch.where(has, start + j, cap)
        u, v, ca, cb, cc, lr = tab[:, torch.clamp_max(col, cap - 1)][:, :,
                                                                      None]
        dx, dy = x - u, y - v
        alpha = torch.exp(-0.5 * (ca * dx * dx + cc * dy * dy)
                          - cb * dx * dy + lr)
        hit = live & has[:, None] & (alpha >= ALPHA_SKIP_F32)
        nxt = T * (1.0 - torch.clamp_max(alpha, ALPHA_CLAMP_F32))
        stop = hit & (nxt < T_SAT_F32)
        inc = hit & ~stop
        live &= ~stop
        T = torch.where(inc, nxt, T)
        count += inc
        per_key[col] = inc.sum(1)
    return count, per_key[:cap]


def frame_f64_counts(frame: Frame):
    """``f64_counts`` of the frame, computed once."""
    if not hasattr(frame, "f64"):
        frame.f64 = f64_counts(frame)
    return frame.f64


def count_check(label: str, what: str, kernel, plain, exact) -> dict:
    """How many of the entries have a kernel or plain count other than
    the float64 blend's (``exact``), and the first ten such entries as
    (flat index, kernel, plain, float64); printed and kept in
    COUNT_CHECK."""
    kernel, plain, exact = (a.reshape(-1) for a in (kernel, plain, exact))
    odd = torch.nonzero((kernel != exact) | (plain != exact)).flatten()[:10]
    out = {"entries": int(exact.numel()),
           "kernel_differs_from_f64": int((kernel != exact).sum()),
           "plain_differs_from_f64": int((plain != exact).sum()),
           "kernel_differs_from_plain": int((kernel != plain).sum()),
           "first": [[int(i), int(kernel[i]), int(plain[i]), int(exact[i])]
                     for i in odd.tolist()]}
    print(f"  {label} {what} count check against a float64 sequential "
          f"blend: {out}", flush=True)
    COUNT_CHECK[f"{label} {what}"] = out
    return out


# --- phase 1: kernels against their plain versions ------------------------

def check_expand(frame: Frame, label: str, first) -> float:
    """K1a and K1b against their plain versions, and the keys, the sort's
    permutation and the sorted table against the first design's (its keys
    and pre-sort table, gathered by the permutation), all bit for bit.
    Returns the largest difference (0)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import expand

    att = frame.expand_args[5]
    fused, owner = expand.slot_keys(*frame.expand_args, **frame.expand_kw)
    fused_p, owner_p = expand.slot_keys_plain(*frame.expand_args,
                                              **frame.expand_kw)
    fused_s, perm = torch.sort(fused, stable=True)
    table = expand.sorted_table(fused_s, perm, owner, att, **frame.table_kw)
    table_p = expand.sorted_table_plain(fused_s, perm, owner, att,
                                        **frame.table_kw)
    fused_1, table_1 = first.expand_keys(*frame.expand_args,
                                         **frame.expand_kw)
    _, perm_1 = torch.sort(fused_1, stable=True)
    gathered_1 = table_1.index_select(1, perm_1)
    gathered_p = expand.expand_keys_plain(
        *frame.expand_args, **frame.expand_kw)[1].index_select(1, perm)
    torch.cuda.synchronize()
    pairs = {"K1a fused vs plain": (fused, fused_p),
             "K1a owner vs plain": (owner, owner_p),
             "K1b table vs plain": (table, table_p),
             "fused vs the first design": (fused, fused_1),
             "orig_slot vs the first design": (perm, perm_1),
             "sorted table vs the first design's, gathered": (table,
                                                              gathered_1),
             "sorted table vs the plain pre-sort table, gathered": (
                 table, gathered_p),
             "main path's sorted table": (frame.table, table),
             "main path's orig_slot": (frame.keys.orig_slot, perm)}
    bad = [n for n, (a, b) in pairs.items() if not torch.equal(a, b)]
    print(f"  {label} expand (K1a, K1b): {len(pairs) - len(bad)} of "
          f"{len(pairs)} bit-identity checks hold", flush=True)
    if bad:
        raise AssertionError(f"{label}: expand differs: " + "; ".join(
            f"{n} (max |d| {max_abs(*pairs[n])})" for n in bad))
    return max(max_abs(a, b) for a, b in pairs.values())


def check_attributes(frame: Frame, label: str) -> float:
    """The point-attributes kernel against its plain version: every field
    bit for bit, NaN where it has NaN."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import attributes as A

    with torch.no_grad():
        got = A.point_attributes(*frame.attr_args)
        want = A.point_attributes_plain(*frame.attr_args)
    torch.cuda.synchronize()
    differ = sum(int((~(torch.eq(g, w) | (g.isnan() & w.isnan()))).sum())
                 for g, w in zip(got, want))
    print(f"  {label} point_attributes: {differ} of "
          f"{sum(g.numel() for g in got)} values differ from the plain "
          f"version", flush=True)
    if differ:
        raise AssertionError(f"{label}: point_attributes differs")
    return 0.0


def check_kernels(frame: Frame, label: str, full_width: bool, first) -> dict:
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, histogram

    errs = {"point_attributes": check_attributes(frame, label),
            "expand_keys": check_expand(frame, label, first)}

    ids = frame.tile_ids
    fused = frame.keys.fused
    bounds = histogram.tile_ranges(fused, frame.dbits, frame.num_tiles)
    pairs = {
        "plain": histogram.tile_ranges_plain(fused, frame.dbits,
                                             frame.num_tiles),
        "torch.searchsorted": torch.searchsorted(ids, torch.arange(
            frame.num_tiles + 1, dtype=torch.int32,
            device=ids.device)).int(),
        "the main path's tile_start": torch.cat([
            frame.keys.tile_start, frame.keys.tile_end[-1:]]),
    }
    torch.cuda.synchronize()
    bad = [n for n, b in pairs.items() if not torch.equal(bounds, b)]
    print(f"  {label} tile_ranges (K2): bit-identical to "
          f"{len(pairs) - len(bad)} of {len(pairs)} ({', '.join(pairs)}); "
          f"{int(bounds[-1])} live of {fused.numel()} keys", flush=True)
    if bad:
        raise AssertionError(f"{label}: tile_ranges differs from "
                             + ", ".join(bad))
    errs["tile_ranges"] = max(max_abs(bounds, b) for b in pairs.values())
    # the tile counters' kernel on the same ranges, against its plain version
    got = torch.full((3,), -1, dtype=torch.int64, device=bounds.device)
    want = torch.empty(3, dtype=torch.int64, device=bounds.device)
    histogram.tile_counts(bounds, got)
    histogram.tile_counts_plain(bounds, want)
    torch.cuda.synchronize()
    print(f"  {label} tile_counts: {dict(zip(histogram.TILE_COUNTS, got.tolist()))}"
          f" over {frame.num_tiles} tiles, bit-identical to its plain "
          f"version: {torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: tile_counts {got.tolist()} differs "
                             f"from its plain version {want.tolist()}")
    errs["tile_counts"] = max_abs(got, want)

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
        if not rgb_only:
            count_check(label, "K3 per-pixel", got[..., 5].long(),
                        want[..., 5].long(), frame_f64_counts(frame)[0])
        if e_rgb > 1e-4 or e_alpha > 1e-4 or e_depth > 5e-4:
            raise AssertionError(f"{label}: blend_forward outside tolerance")
        limit = 1e-4 * got.shape[0] * got.shape[1] if full_width else 0
        if n_count > limit:
            raise AssertionError(f"{label}: blend counts differ at {n_count} px")
        worst = max(worst, e_rgb, e_alpha)
    errs["blend_forward"] = worst
    return errs


# --- phase 1b: the backward kernels against their plain versions ---------

def check_backward_kernels(frame: Frame, label: str, full_width: bool,
                           first):
    """blend_backward and segment_reduce against their plain versions on
    the frame's keys, a seeded rgb cotangent and the forward's rgb, and
    segment_reduce against the first design's. Returns (errors, K4 plain
    device ms of its one call, the inputs kept for timing)."""
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
    count_check(label, "K4 per-key", got[11, live].long(),
                want[11, live].long(), frame_f64_counts(frame)[1][live])
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

    rows = got[0:12]
    inv = tiling.inverse_permutation(k.orig_slot)
    seg = sr.segment_reduce_sorted(rows, inv, k.offsets, k.counts)
    seg_p = sr.segment_reduce_sorted_plain(rows, inv, k.offsets, k.counts)
    seg_1 = first.segment_reduce(tiling.regroup_rows_by_slot(rows, k.orig_slot),
                                 k.offsets, k.counts)
    torch.cuda.synchronize()
    e_seg = max(max_abs(seg, seg_p), max_abs(seg, seg_1))
    # both add each segment's lanes in slot order from 0
    print(f"  {label} segment_reduce (through the inverse permutation): "
          f"bit-identical to its plain version {torch.equal(seg, seg_p)}, to "
          f"the first design's regroup + kernel {torch.equal(seg, seg_1)}",
          flush=True)
    if not (torch.equal(seg, seg_p) and torch.equal(seg, seg_1)):
        raise AssertionError(f"{label}: segment_reduce differs (max |d| "
                             f"{e_seg})")
    return ({"blend_backward": e_rows, "segment_reduce": e_seg}, plain_ms,
            {"bwd_args": args, "rows": rows, "inv": inv})


# --- phase 4: training --------------------------------------------------------

def train_setup(xyz, feats, camera, cfg_kw, device="cuda"):
    """bench.py's train step at full width: the step, a fresh state of the
    scene (numpy arrays through convert.train_state_from_jax) and its
    uint8 target, rendered from the scene with seeded noise (sigma 0.3) on
    the DC colour features (columns 8, 24, 40); on ``device``."""
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
                                 device=device)
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
                                   device=device)
    return config, step, state, (gt, q, t, camera.K, 3)


def train_stage_ms(config, state, inputs) -> dict:
    """Wall and device ms of each stage of one train step, each timed
    alone on its own inputs (their sum approximates the step)."""
    import dataclasses

    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        attributes as A, blend, segment_reduce as sr, tiling,
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
    x, f = s.xyz.detach(), s.features.detach()

    def attrs():
        with torch.no_grad():
            return R.compute_raw_attrs(x, f, q, t, cam, band)
    out["attributes (the kernel)"] = both_ms(attrs, reps,
                                             ("point_attributes_kernel(",))
    raw_v, radius = attrs()
    keys_fn = lambda: R.build_keys(raw_v, radius, s.invalid,  # noqa: E731
                                   cam, cfg)
    out["tiling (cull, keys, K1a, sort, K1b, K2)"] = both_ms(
        keys_fn, reps, ("slot_keys_kernel(", "sorted_table_kernel(",
                        "tile_ranges_kernel(") + SORT)
    keys, table, visible = keys_fn()
    k3 = lambda: blend.blend_forward(  # noqa: E731
        table, keys.tile_start, keys.tile_end, tile=tile, tiles_x=grid[0],
        tiles_y=grid[1], rgb_only=True)
    out["blend_forward (K3)"] = both_ms(k3, reps, ("blend_forward_kernel(",))
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
        loss, reps, EW)
    d_pred, _ = loss()
    d_tiles = R._image_to_tiles(d_pred, grid[0], grid[1], tile)
    cfin = out_tiles[..., 0:3].contiguous()
    k4 = lambda: blend.blend_backward(  # noqa: E731
        table, keys.tile_start, keys.tile_end, d_tiles, cfin, tile=tile,
        tiles_x=grid[0], tiles_y=grid[1], imggrad=False)
    out["blend_backward (K4)"] = both_ms(k4, reps,
                                         ("blend_backward_kernel(",))
    d_table, _ = k4()
    rows = d_table[0:12]
    inv_fn = lambda: tiling.inverse_permutation(keys.orig_slot)  # noqa: E731
    out["inverse key permutation"] = both_ms(inv_fn, reps, EW)
    inv = inv_fn()
    k5 = lambda: sr.segment_reduce_sorted(rows, inv, keys.offsets,  # noqa: E731
                                          keys.counts)
    out["segment_reduce (K5, through the inverse permutation)"] = both_ms(
        k5, reps, ("segment_reduce_kernel(",))
    d_raw, (mag, npix, _) = R._blend_bwd_impl(
        raw_v, keys, table, out_tiles, d_tiles, tile, grid, cfg)

    def vjp():
        return A.point_attributes_vjp(x, f, q, t, K, band, 0, None, d_raw.uv,
                                      d_raw.conic, d_raw.opacity, d_raw.color)
    out["attribute VJP (the kernel)"] = both_ms(
        vjp, reps, ("point_attributes_vjp_kernel(",))
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
    out["grad factors, two Adams, accumulate"] = both_ms(update, reps, EW)
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
    zero_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    steps = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with first_design_calls() as off_path:
        start.record()
        for _ in range(steps):
            metrics = one_step()
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / steps
    launches = read_launches(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_list = [float(v) for v in losses]
    print(f"  {steps} timed steps: {step_ms:.3f} ms/step; losses "
          f"{loss_list[0]:.6f} (first) -> {loss_list[-1]:.6f} (last); "
          f"launches {launches}; first design's calls {off_path}", flush=True)
    if not all(bool(v) for v in finite):
        raise AssertionError("a non-finite loss or gradient")
    if not loss_list[-1] < loss_list[0]:
        raise AssertionError("the loss did not fall")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"{name}: {n} launches in {steps} steps")
    if any(off_path.values()):
        raise AssertionError(f"the train step ran the first design's data "
                             f"movement: {off_path}")
    stages = train_stage_ms(config, state, inputs)
    for name, v in stages.items():
        print(f"  train stage {name}: wall {v['wall_ms']:.4f} ms, device "
              f"{v['device_ms']:.4f} ms", flush=True)
    busy = device_busy(one_step, reps=5,
                       expect=("blend_backward_kernel(",
                               "segment_reduce_kernel("))
    print(f"  train profiler: {busy}", flush=True)
    return {"train_ms_per_step": step_ms,
            "train_mpix_s": HEIGHT * WIDTH / 1e6 / (step_ms / 1e3),
            "train_steps_timed": steps, "train_losses": loss_list,
            "train_num_keys": int(metrics["num_keys"]),
            "train_launches": launches, "train_first_design_calls": off_path,
            "train_launches_per_step": {n: v / steps
                                        for n, v in launches.items()},
            "train_peak_mem_gib": peak_gib, "train_stage_ms": stages,
            "train_device_ms_per_step": busy["device_busy_ms"] / 5,
            "train_profile": busy}


# --- phase 5: the training loop -------------------------------------------------

LOOP_ITERS = 40
LOOP_SIZES = {(HEIGHT // 2 - (HEIGHT // 2) % TILE, WIDTH // 2): "480x256",
              (HEIGHT, WIDTH): f"{WIDTH}x{HEIGHT}"}


class MemoryViews:
    """ImagePoseDataset's interface over DatasetItems held in memory
    (``records``: the metadata a data-parallel trainer decides sizes by)."""

    def __init__(self, items):
        self.items = items
        self.records = [{"camera_height": it.camera_info.camera_height,
                         "camera_width": it.camera_info.camera_width}
                        for it in items]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def loop_views(K_np, dev, count=8, points=N_POINTS, width=WIDTH,
               height=HEIGHT):
    """``count`` DatasetItems at ``width`` x ``height`` (960x544),
    rendered at ``poses(count)`` from a second seeded scene of ``points``
    and quantized to 8 bits as a PNG decode gives them (uint8 / 255 in
    f32)."""
    from taichi_3d_gaussian_splatting_tpu_torch.data.camera import CameraInfo
    from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
        DatasetItem,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
        se3_to_qt,
    )

    put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xyz_t, feats_t = truck_scene_surround(points, seed=1)
    xyz_t, feats_t = put(xyz_t), put(feats_t)
    invalid = torch.zeros(points, dtype=torch.bool, device=dev)
    qs, ts = se3_to_qt(put(poses(count)))
    cam = R.Camera(put(K_np), width, height)
    cfg = R.RasterizerConfig(rgb_only=True, tile_size=TILE)
    items = []
    for i in range(count):
        rgb = R.rasterize(xyz_t, feats_t, invalid, qs[i], ts[i], cam, cfg).rgb
        u8 = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
        items.append(DatasetItem(
            image=u8.cpu().numpy().astype(np.float32) / 255.0,
            q_pointcloud_camera=qs[i].cpu().numpy(),
            t_pointcloud_camera=ts[i].cpu().numpy(),
            camera_info=CameraInfo(K_np.copy(), height, width, 0), index=i))
    return items


def loop_config_dict(log_dir: str, **over) -> dict:
    """The loop's schedule as the fields of a config file."""
    d = {
        "num_iterations": LOOP_ITERS, "val_interval": 20,
        "initial_downsample_factor": 2, "half_downsample_factor_interval": 20,
        "increase_color_max_sh_band_interval": 10,
        "log_loss_interval": 10, "log_metrics_interval": 20,
        "print_metrics_to_console": True, "num_data_threads": 2,
        "summary_writer_log_dir": log_dir,
        "rasterisation_config": {"tile_size": TILE},
        "adaptive_controller_config": {
            "num_iterations_warm_up": 10, "num_iterations_densify": 10,
            "num_iterations_reset_alpha": 25,
            # every in-camera point with any gradient densifies: each round
            # fills the free and the pruned slots
            "densification_view_space_position_gradients_threshold": 1e-12,
        },
        "gaussian_point_cloud_scene_config": {"max_num_points_ratio": 1.25},
    }
    d.update(over)
    return d


def loop_config(log_dir: str, **over):
    """The loop's schedule, built without YAML."""
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )

    return from_dict(loop_config_dict(log_dir, **over))


def loop_trainer_class(train_items, val_items, xyz, feats, saved_as):
    """The trainer with in-memory views, the phase-4 scene in a padded
    pool, and scene files written as .parquet, or as .ply where pandas or
    its parquet engine is missing (``saved_as`` records which)."""
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    class SmokeTrainer(trainer.GaussianPointCloudTrainer):
        def _load_datasets(self):
            return MemoryViews(train_items), MemoryViews(val_items)

        def _load_scene(self):
            return scene_lib.create_scene(
                xyz, self.config.gaussian_point_cloud_scene_config,
                features=feats, device=self.device)

        def _save_scene(self, scene, path):
            try:
                scene_lib.to_parquet(scene, path)
            except ImportError as e:
                path = str(Path(path).with_suffix(".ply"))
                scene_lib.to_ply(scene, path)
                if not saved_as:
                    print(f"  scene files as .ply: no parquet writer ({e})",
                          flush=True)
            if not saved_as:
                print(f"  scene files written as {Path(path).suffix}",
                      flush=True)
            saved_as.append(path)

    return SmokeTrainer


@contextlib.contextmanager
def plain_calls():
    """Counts, while open, the calls of the plain versions of the main
    path's kernels (the wrappers take them for CPU tensors only)."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        attributes as A, blend, expand, histogram, segment_reduce as sr,
    )

    fns = [(A, "point_attributes_vjp_plain"),
           (expand, "slot_keys_plain"), (expand, "sorted_table_plain"),
           (histogram, "tile_ranges_plain"), (blend, "blend_forward_plain"),
           (blend, "blend_backward_plain"),
           (sr, "segment_reduce_sorted_plain")]
    calls = {name: 0 for _, name in fns}
    saved = [getattr(mod, name) for mod, name in fns]

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    for (mod, name), fn in zip(fns, saved):
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(fns, saved):
            setattr(mod, name, fn)


def synced_ms(fn, *a, **kw):
    """(fn's result, its ms between two device synchronizations)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def timed_calls(obj, name: str, sink: dict):
    """Replace ``obj.name`` by a wrapper that appends the ms of each call
    (between two device syncs) to ``sink[name]``; returns the original."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        out, ms_ = synced_ms(fn, *a, **kw)
        sink.setdefault(name, []).append(ms_)
        return out

    setattr(obj, name, timed)
    return fn


def run_loop(xyz, feats, K_np, step_ms: float, kernels, dev="cuda"):
    """Phase 5: ``GaussianPointCloudTrainer.train()`` at full width, then a
    resume from its checkpoint. Returns the loop's record and its final
    scene."""
    from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint
    from taichi_3d_gaussian_splatting_tpu_torch.training import (
        trainer as trainer_mod,
    )

    views = loop_views(K_np, dev)
    saved_as = []
    Trainer = loop_trainer_class(views[:6], views[6:], xyz, feats, saved_as)
    log_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(loop_config(log_dir.name), device=dev)
    capacity, n_valid0 = trainer.scene.capacity, int(trainer.scene.num_valid())
    marks, losses, num_keys, rounds, evals, saves = [], [], [], [], [], {}
    host = {}  # ms of each call of the loop's host-side pieces

    get_step = trainer._get_step

    def timed_get_step(h, w):
        step = get_step(h, w)

        def timed(state, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, *a)
            torch.cuda.synchronize()
            marks.append(((h, w), t0, time.perf_counter()))
            losses.append(out[1]["loss"])
            num_keys.append(out[1]["num_keys"])
            return out
        return timed

    find, apply = trainer.densify_find, trainer.densify_apply

    def timed_find(*a):
        info, find_ms = synced_ms(find, *a)
        rounds.append({"find_ms": find_ms})
        return info

    def timed_apply(scene, info, generator):
        (new_scene, new_ctrl), apply_ms = synced_ms(apply, scene, info,
                                                    generator)
        rounds[-1].update(
            apply_ms=apply_ms, iteration=len(marks) - 1,
            num_valid_before=int(scene.num_valid()),
            num_valid_after=int(new_scene.num_valid()),
            densify=int(info.densify_mask.sum()),
            removed=int(info.remove_mask.sum()))
        return new_scene, new_ctrl

    eval_frame = trainer._eval_frame

    def timed_eval(*a):
        out, ms_ = synced_ms(eval_frame, *a)
        evals.append(ms_)
        return out

    save = checkpoint.save_checkpoint

    def timed_save(path, state, meta):
        _, ms_ = synced_ms(save, path, state, meta)
        # the train step and the controller build new tensors, so the state
        # saved here stays as it was for the resume check below
        saves.update(ms=ms_, state=state, meta=meta)

    trainer._get_step = timed_get_step
    trainer.densify_find, trainer.densify_apply = timed_find, timed_apply
    trainer._eval_frame = timed_eval
    for name in ("_item_tensors", "_save_scene", "_log_step"):
        timed_calls(trainer, name, host)
    downsample = timed_calls(trainer_mod, "downsample_item", host)
    checkpoint.save_checkpoint = timed_save
    zero_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with plain_calls() as plain, first_design_calls() as off_path:
            state = trainer.train()
            torch.cuda.synchronize()
    finally:
        checkpoint.save_checkpoint = save
        trainer_mod.downsample_item = downsample
    train_s = time.perf_counter() - t0
    # the end-to-end figure: the whole train() window over its iterations
    # (densify, resets, validation, exports and start-up included)
    loop_ms = train_s * 1e3 / max(len(marks), 1)
    launches = read_launches(kernels)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_list = [float(v) for v in losses]

    # an iteration's wall: from its step's start to the next step's start
    # (the step, then densify, logging, validation, the next item's fetch)
    densify_its = {r["iteration"] for r in rounds}
    by_size, busy_iters = {}, {}
    for i in range(len(marks) - 1):
        size = LOOP_SIZES.get(marks[i][0], str(marks[i][0]))
        wall = (marks[i + 1][1] - marks[i][1]) * 1e3
        step_i = (marks[i][2] - marks[i][1]) * 1e3
        first_of_size = i == 0 or marks[i - 1][0] != marks[i][0]
        special = (first_of_size or i in densify_its or i == 25 or i == 20
                   or i % 20 == 0)
        if special:
            busy_iters[i] = wall
            continue
        by_size.setdefault(size, []).append((wall, step_i))
    iteration_ms = {s: float(np.median([w for w, _ in v]))
                    for s, v in by_size.items()}
    step_in_loop_ms = {s: float(np.median([st for _, st in v]))
                       for s, v in by_size.items()}
    host_ms = {k: {"calls": len(v), "median_ms": float(np.median(v)),
                   "max_ms": float(max(v))} for k, v in host.items()}
    # the same step on the loop's last state, back to back as in phase 4
    item = views[6]
    st = state
    args = trainer._item_tensors(item)
    bare_step = get_step(HEIGHT, WIDTH)

    def one_step():
        nonlocal st
        st = bare_step(st, *args, 3)[0]
    bare_ms = cuda_ms(one_step, reps=10, warmup=2)
    files = sorted(p.name for p in Path(log_dir.name).iterdir())
    print(f"  {len(marks)} iterations in {train_s:.2f} s, {loop_ms:.2f} ms "
          f"an iteration over the whole window; ms an iteration "
          f"(median of the plain ones) {iteration_ms}, of which the step "
          f"(between syncs) {step_in_loop_ms}; the loop's step back to "
          f"back on its last state {bare_ms:.3f} ms, phase 4's "
          f"{step_ms:.3f} ms; keys a step {num_keys[0]} (first), "
          f"{num_keys[19]} (last at 480x256), {num_keys[-1]} (last); "
          f"iterations with densify / reset / validation / metrics "
          f"{busy_iters}", flush=True)
    print(f"  host pieces {host_ms}", flush=True)
    print(f"  densify rounds {rounds}; validation frames {evals} ms; "
          f"checkpoint save {saves.get('ms')} ms; files {files}", flush=True)
    print(f"  losses {loss_list[0]:.5f} (first) -> {loss_list[-1]:.5f} "
          f"(last); launches {launches}; plain versions {plain}; first "
          f"design's calls {off_path}; peak {peak_gib:.2f} GiB", flush=True)

    if len(marks) != LOOP_ITERS or not all(math.isfinite(v)
                                           for v in loss_list):
        raise AssertionError("the loop did not run its iterations with "
                             "finite losses")
    if not any(r["num_valid_after"] != r["num_valid_before"] for r in rounds):
        raise AssertionError("no densify round changed num_valid")
    if not saves or "checkpoint_latest" not in files or not saved_as:
        raise AssertionError("the validation wrote no scene or checkpoint")
    n_renders = LOOP_ITERS + len(evals)
    want = {"slot_keys": n_renders, "sorted_table": n_renders,
            "tile_ranges": n_renders, "blend_forward": n_renders,
            "blend_backward": LOOP_ITERS,
            "segment_reduce_sorted": LOOP_ITERS}
    if launches != want:
        raise AssertionError(f"loop launches {launches}, expected {want}")
    if any(plain.values()) or any(off_path.values()):
        raise AssertionError(f"the loop ran a plain version or the first "
                             f"design: {plain} {off_path}")

    # resume a fresh trainer from the checkpoint: with num_iterations one
    # past the saved iteration, train() runs nothing and returns the
    # restored state
    saved_it = int(saves["meta"]["iteration"])
    resumed = Trainer(loop_config(
        log_dir.name + "/resumed", num_iterations=saved_it + 1,
        resume_from=str(Path(log_dir.name) / "checkpoint_latest")),
        device=dev)
    restored, resume_ms = synced_ms(resumed.train)
    same = [bool(torch.equal(a, b)) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(checkpoint.state_leaves(restored),
                            checkpoint.state_leaves(saves["state"]))]
    same_rng = (resumed.generator.get_state().tolist()
                == saves["meta"]["rng_state"])
    print(f"  resumed at iteration {saved_it + 1} in {resume_ms:.1f} ms: "
          f"{sum(same)} of {len(same)} leaves equal, generator state equal "
          f"{same_rng}", flush=True)
    if not (all(same) and same_rng):
        raise AssertionError("the resumed state differs from the saved one")
    log_dir.cleanup()
    return {
        "loop_iterations": len(marks), "loop_train_s": train_s,
        "loop_ms_per_iteration": loop_ms,
        "loop_capacity": capacity, "loop_num_valid_start": n_valid0,
        "loop_num_valid_end": int(state.scene.num_valid()),
        "loop_iteration_ms": iteration_ms,
        "loop_step_in_loop_ms": step_in_loop_ms,
        "loop_bare_step_ms": bare_ms, "loop_host_ms": host_ms,
        "loop_num_keys": num_keys, "loop_phase4_step_ms": step_ms,
        "loop_special_iteration_ms": busy_iters,
        "loop_densify_rounds": rounds, "loop_validation_frame_ms": evals,
        "loop_checkpoint_save_ms": saves["ms"], "loop_resume_ms": resume_ms,
        "loop_losses": loss_list, "loop_launches": launches,
        "loop_plain_calls": plain, "loop_first_design_calls": off_path,
        "loop_peak_mem_gib": peak_gib, "loop_scene_files": saved_as,
    }, state.scene


# --- phases 6-8: the plain route ---------------------------------------------

@contextlib.contextmanager
def plain_route():
    """While open, every kernel wrapper of the main path is replaced by its
    plain version, so a call through the entry points runs the plain
    versions on the card's tensors (the comparisons of phases 6-8). No
    launch counter moves."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        attributes as A, blend, expand, histogram, segment_reduce as sr,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    swaps = [(R, "point_attributes", R.point_attributes_plain),
             (R, "point_attributes_vjp", A.point_attributes_vjp_plain),
             (expand, "slot_keys", expand.slot_keys_plain),
             (expand, "sorted_table", expand.sorted_table_plain),
             (histogram, "tile_ranges", histogram.tile_ranges_plain),
             (blend, "blend_forward", blend.blend_forward_plain),
             (blend, "blend_backward", blend.blend_backward_plain),
             (R, "segment_reduce_sorted", sr.segment_reduce_sorted_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


# --- phase 6: the pose-refining train step -----------------------------------

POSE_WARM = 2     # pose_refinement_warm_up: steps whose view index is -1
POSE_VIEWS = 3


def pose_views(K_np, xyz, feats, dev):
    """POSE_VIEWS views of the phase-4 scene: uint8 targets rendered at the
    poses of ``poses()`` from the scene with seeded noise (sigma 0.3) on its
    DC colours, as phase 4's, and each view's pose perturbed by a seeded
    rotation of up to 0.01 rad about each axis and a shift of up to 2 cm
    (what the refinement is to undo). Returns [(gt, q, t)], the perturbed
    poses."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
        quaternion_exp, quaternion_multiply, se3_to_qt,
    )

    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    rng = np.random.default_rng(11)
    n = xyz.shape[0]
    feats_gt = feats.copy()
    feats_gt[:, [8, 24, 40]] += rng.normal(0.0, 0.3, (n, 3)).astype(
        np.float32)
    qs, ts = se3_to_qt(put(poses(POSE_VIEWS)))
    cam = R.Camera(put(K_np), WIDTH, HEIGHT)
    cfg = R.RasterizerConfig(rgb_only=True, tile_size=TILE)
    x, f = put(xyz), put(feats_gt)
    invalid = torch.zeros(n, dtype=torch.bool, device=dev)
    rng = np.random.default_rng(17)
    views = []
    for i in range(POSE_VIEWS):
        rgb = R.rasterize(x, f, invalid, qs[i], ts[i], cam, cfg).rgb
        gt = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
        w = put(rng.uniform(-0.01, 0.01, 3).astype(np.float32))
        dt = put(rng.uniform(-0.02, 0.02, 3).astype(np.float32))
        views.append((gt, quaternion_multiply(qs[i], quaternion_exp(w)),
                      ts[i] + dt))
    return views


def run_pose_training(xyz, feats, K_np, step_ms: float, kernels,
                      dev="cuda") -> dict:
    """Phase 6: make_train_step with pose_refinement on the phase-4 scene,
    POSE_VIEWS views with perturbed poses in turn: 3 warm-up steps (the
    first POSE_WARM with view index -1) and 20 timed ones with the launch
    counts read around them; then one step's pose cotangent against the
    plain route's on the same state and inputs."""
    from taichi_3d_gaussian_splatting_tpu_torch.convert import (
        train_state_from_jax,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        TrainConfig,
    )

    dev = torch.device(dev)
    n = xyz.shape[0]
    config = TrainConfig(
        rasterisation_config=R.RasterizerConfig(tile_size=TILE),
        pose_refinement=True, pose_refinement_warm_up=POSE_WARM)
    zeros = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731

    def adam(p):
        return {"mu": np.zeros_like(p), "nu": np.zeros_like(p), "count": 0}
    state = train_state_from_jax(
        {"xyz": xyz, "features": feats, "invalid": np.zeros((n,), bool),
         "object_id": np.zeros((n,), np.int32)}, adam(feats), adam(xyz),
        {f: zeros(n, 3) if f == "grad_position" else zeros(n)
         for f in ("num_pixels", "num_in_camera", "grad_viewspace",
                   "grad_viewspace_avg", "grad_position",
                   "grad_position_norm")},
        pose_deltas=zeros(POSE_VIEWS, 6),
        pose_opt={"mu": zeros(POSE_VIEWS, 6), "nu": zeros(POSE_VIEWS, 6),
                  "count": zeros(POSE_VIEWS)}, device=dev)
    views = pose_views(K_np, xyz, feats, dev)
    K = torch.from_numpy(K_np).to(dev)
    step = trainer.make_train_step(config, HEIGHT, WIDTH, device=dev)
    it = {"i": 0}
    losses, finite = [], []

    def one_step():
        nonlocal state
        i = it["i"]
        it["i"] += 1
        gt, q, t = views[i % POSE_VIEWS]
        idx = -1 if i < POSE_WARM else i % POSE_VIEWS
        state, metrics, aux = step(state, gt, q, t, K, 3, idx)
        losses.append(metrics["loss"])
        checks = [metrics["loss"], state.pose_deltas]
        if idx >= 0:
            checks += [aux["grad_q"], aux["grad_t"], aux["grad_pose"]]
        finite.append(torch.stack([torch.isfinite(c).all() for c in checks])
                      .all())
        return aux

    warm_deltas = []
    for _ in range(3):
        one_step()
        warm_deltas.append(float(state.pose_deltas.abs().max()))
    torch.cuda.synchronize()
    zero_launches(kernels)
    steps = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        one_step()
    end.record()
    torch.cuda.synchronize()
    pose_ms = start.elapsed_time(end) / steps
    launches = read_launches(kernels)
    loss_list = [float(v) for v in losses]
    deltas = state.pose_deltas.cpu().numpy()
    print(f"  {steps} timed pose-refining steps: {pose_ms:.3f} ms/step "
          f"(phase 4's step {step_ms:.3f} ms); losses {loss_list[0]:.6f} "
          f"(first) -> {loss_list[-1]:.6f} (last); launches {launches}; "
          f"max |pose delta| after each warm-up step {warm_deltas}; "
          f"pose deltas {deltas.round(6).tolist()}; Adam counts "
          f"{state.pose_opt['count'].tolist()}", flush=True)
    if not all(bool(v) for v in finite):
        raise AssertionError("a non-finite loss, pose gradient or delta")
    if warm_deltas[:POSE_WARM] != [0.0] * POSE_WARM or warm_deltas[-1] == 0:
        raise AssertionError(f"the pose deltas moved during the warm-up or "
                             f"not after it: {warm_deltas}")
    for name, n_ in launches.items():
        if n_ != steps:
            raise AssertionError(f"{name}: {n_} launches in {steps} "
                                 f"pose-refining steps")

    # one step's pose cotangent, kernels against the plain route
    gt, q, t = views[0]
    saved = state
    aux_k = step(saved, gt, q, t, K, 3, 0)[2]
    with plain_route():
        aux_p = step(saved, gt, q, t, K, 3, 0)[2]
    torch.cuda.synchronize()
    got, want = aux_k["grad_pose"].double(), aux_p["grad_pose"].double()
    rel = float((got - want).norm() / want.norm())
    print(f"  pose cotangent (se(3) 6-vector) kernels {got.tolist()}, plain "
          f"{want.tolist()}: |d| / |plain| = {rel:.3g} (gate 1e-3)",
          flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"the pose cotangent differs from the plain "
                             f"route's: {rel:.3g} of its norm")
    def view_step():
        # one view, so that every call launches the same kernels (the
        # elementwise kernels' vector width follows each view's key total)
        nonlocal saved
        saved = step(saved, gt, q, t, K, 3, 0)[0]
    busy = device_busy(view_step, reps=5,
                       expect=("blend_backward_kernel(",
                               "segment_reduce_kernel("))
    print(f"  pose-refining step profiler (view 0): {busy}", flush=True)
    return {"pose_ms_per_step": pose_ms, "pose_phase4_step_ms": step_ms,
            "pose_steps_timed": steps, "pose_losses": loss_list,
            "pose_launches": launches,
            "pose_warm_up_max_delta": warm_deltas,
            "pose_deltas": deltas.tolist(),
            "pose_cotangent_rel_err": rel,
            "pose_cotangent": got.tolist(),
            "pose_device_ms_per_step": busy["device_busy_ms"] / 5,
            "pose_profile": busy}


# --- phase 7: the viewer -----------------------------------------------------

VIEWER_SECOND_POINTS = 200_000
VIEWER_EVENTS = [{"key": "1"}, {"key": "w"}, {"key": "d"},
                 {"dx": 0.05, "dy": 0.02}, {"key": "h"}, {"key": "p"},
                 {"key": "0"}, {"key": "s"}, {"key": "a"},
                 {"dx": -0.03, "dy": 0.04}]


def run_viewer(xyz, feats, kernels, tmp: Path, dev="cuda") -> dict:
    """Phase 7: ``apps/visualizer.py``'s viewer at its default 992x544 over
    two scenes (the phase-4 scene and a seeded one of 200,000 points, as
    .ply files), its HTTP server on a free port, VIEWER_EVENTS posted to
    /event with a frame read after each (from /frame as JPEG, or through
    ``render_frame`` where PIL is missing), the launch counts read around
    the session; then the per-object frame against the single-pose render
    (equal poses) and against the plain route (distinct poses)."""
    import importlib.util
    import urllib.request

    from taichi_3d_gaussian_splatting_tpu_torch.apps import visualizer as V
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    paths = []
    for name, (x, f) in (("a", (xyz, feats)), ("b", truck_scene_surround(
            VIEWER_SECOND_POINTS, seed=2))):
        path = str(tmp / f"{name}.ply")
        scene_lib.to_ply(scene_lib.create_scene(x, scene_lib.SceneConfig(),
                                                features=f, device="cpu"),
                         path)
        paths.append(path)
    vis = V.GaussianPointVisualizer(V.VisualizerConfig(parquet_paths=paths),
                                    device=dev)
    has_pil = importlib.util.find_spec("PIL") is not None
    if not has_pil:
        print("  no PIL on this machine: frames are read through the "
              "viewer's render_frame, not as JPEG from /frame", flush=True)
    server = V.make_server(vis, 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def frame():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if has_pil:
            data = urllib.request.urlopen(url + "/frame", timeout=120).read()
        else:
            data = vis.render_frame().cpu().numpy().tobytes()
        return data, (time.perf_counter() - t0) * 1e3

    try:
        frame()  # warm-up
        zero_launches(kernels)
        frames, ms_ = [], []
        for ev in [None] + VIEWER_EVENTS:
            if ev is not None:
                req = urllib.request.Request(
                    url + "/event", data=json.dumps(ev).encode(),
                    method="POST")
                if urllib.request.urlopen(req, timeout=30).status != 204:
                    raise AssertionError(f"/event refused {ev}")
            data, t_ms = frame()
            frames.append(data)
            ms_.append(t_ms)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the viewer's server thread did not stop")
    n_frames = len(frames)
    render_ms = [synced_ms(vis.render_frame)[1] for _ in range(10)]
    changed = [frames[i] != frames[i - 1] for i in range(1, n_frames)]
    print(f"  {n_frames} frames over HTTP ({'JPEG' if has_pil else 'raw'}), "
          f"ms each {[round(v, 2) for v in ms_]}, median "
          f"{float(np.median(ms_)):.2f} ms; render_frame median "
          f"{float(np.median(render_ms)):.2f} ms; frame changed after "
          f"{[ev for ev, c in zip(VIEWER_EVENTS, changed) if c]}; launches "
          f"{launches}", flush=True)
    # selecting an object changes nothing on screen; every other event does,
    # and showing restores the frame before the hide
    for ev, c in zip(VIEWER_EVENTS, changed):
        if c != ("key" not in ev or not ev["key"].isdigit()):
            raise AssertionError(f"frame {'changed' if c else 'unchanged'} "
                                 f"after {ev}")
    hide = VIEWER_EVENTS.index({"key": "h"}) + 1
    if frames[hide + 1] != frames[hide - 1]:
        raise AssertionError("hide then show did not restore the frame")
    want = {"slot_keys": n_frames, "sorted_table": n_frames,
            "tile_ranges": n_frames, "blend_forward": n_frames,
            "blend_backward": 0, "segment_reduce_sorted": 0}
    if launches != want:
        raise AssertionError(f"viewer launches {launches}, expected {want}")

    # distinct per-object poses (object 1 moved and spun): kernels against
    # the plain route
    if np.allclose(vis.q[0], vis.q[1]) and np.allclose(vis.t[0], vis.t[1]):
        raise AssertionError("the events left the object poses equal")
    got = vis.render_frame()
    with plain_route():
        plain = vis.render_frame()
    torch.cuda.synchronize()
    e_rgb = max_abs(got, plain)
    # equal poses: the per-object frame is the single-pose render
    vis.q[:] = vis.q[0]
    vis.t[:] = vis.t[0]
    s = vis.scene
    single = torch.clamp(R.rasterize(
        s.xyz, s.features, s.invalid, torch.from_numpy(vis.q[0]).to(dev),
        torch.from_numpy(vis.t[0]).to(dev), vis.camera, vis.rcfg,
        point_object_id=s.object_id).rgb, 0.0, 1.0)
    same = bool(torch.equal(vis.render_frame(), single))
    print(f"  distinct object poses: max|d rgb| against the plain route "
          f"{e_rgb:.3g} (gate 1e-4); equal poses bit-identical to the "
          f"single-pose render: {same}", flush=True)
    if e_rgb > 1e-4 or not same:
        raise AssertionError("viewer frame outside its gates")
    return {"viewer_frames": n_frames, "viewer_jpeg": has_pil,
            "viewer_frame_ms": ms_,
            "viewer_frame_ms_median": float(np.median(ms_)),
            "viewer_render_ms_median": float(np.median(render_ms)),
            "viewer_points": s.capacity, "viewer_image": [vis.width,
                                                          vis.height],
            "viewer_launches": launches, "viewer_plain_rgb_err": e_rgb}


# --- phase 8: rendering a dataset .json --------------------------------------

DATASET_VIEWS = 3


def write_views(tmp: Path, K_np, count: int, dev, png: bool = True):
    """A dataset .json of ``count`` views at 960x544 (``loop_views``, at
    ``poses(count)``) in ``tmp``, each written as a PNG (unless not
    ``png``): (json path, the DatasetItems, the poses)."""
    Ts = poses(count)
    items = loop_views(K_np, dev, count=count)
    records = []
    for i, item in enumerate(items):
        path = tmp / f"view_{i}.png"
        if png:
            from PIL import Image

            Image.fromarray(np.round(item.image * 255).astype(np.uint8),
                            "RGB").save(path)
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": Ts[i].tolist(),
                        "camera_intrinsics": K_np.tolist(),
                        "camera_height": HEIGHT, "camera_width": WIDTH,
                        "camera_id": 0})
    json_path = tmp / "views.json"
    json_path.write_text(json.dumps(records))
    return json_path, items, Ts


def run_dataset_render(xyz, feats, K_np, kernels, tmp: Path,
                       dev="cuda") -> dict:
    """Phase 8: ``apps/render.py`` from a dataset .json (``poses_from_dataset``
    and the renderer at the size and intrinsics of its last item), rgb_only
    with ``pack_sort_colors``: DATASET_VIEWS PNG views written to ``tmp``
    (or, where PIL is missing, items served from memory by a dataset
    subclass), the launch counts read around the frames; the table's r and
    g rows against round_bf16 of the unpacked rows, and K3's packed frame
    against the plain blend of the same table."""
    import dataclasses
    import importlib.util

    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.data import dataset as D
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.ops.packing import round_bf16

    ply = str(tmp / "dataset_scene.ply")
    scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                            features=feats, device="cpu"),
                     ply)
    has_pil = importlib.util.find_spec("PIL") is not None
    json_path, items, Ts = write_views(tmp, K_np, DATASET_VIEWS, dev,
                                       png=has_pil)
    dataset_cls = D.ImagePoseDataset
    if not has_pil:
        print("  no PIL on this machine: the dataset's items are served "
              "from memory", flush=True)

        class MemoryPoseDataset(dataset_cls):
            def __getitem__(self, idx):
                return items[idx]
        D.ImagePoseDataset = MemoryPoseDataset
    try:
        Ts_read, info = render.poses_from_dataset(str(json_path))
    finally:
        D.ImagePoseDataset = dataset_cls
    config = render.RendererConfig(
        parquet_paths=[ply], image_height=info.camera_height,
        image_width=info.camera_width,
        camera_intrinsics=info.camera_intrinsics)
    renderer = render.GaussianPointRenderer(config, Ts_read, device=dev)
    renderer.rcfg = dataclasses.replace(renderer.rcfg, pack_sort_colors=True)
    zero_launches(kernels)
    frames = dict(renderer.frames())
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    e_pose = float(np.abs(Ts_read - Ts).max())
    # the frames are one graph's replays: K1-K3 launch at its warm-up and
    # capture alone
    want = {"slot_keys": 2, "sorted_table": 2, "tile_ranges": 2,
            "blend_forward": 2, "blend_backward": 0,
            "segment_reduce_sorted": 0}
    if launches != want or renderer.captures != 1:
        raise AssertionError(f"dataset render launches {launches}, "
                             f"expected {want}; {renderer.captures} "
                             f"captures")
    if e_pose > 1e-6 or (info.camera_height, info.camera_width) != (
            HEIGHT, WIDTH):
        raise AssertionError(f"dataset poses or size: {e_pose}, {info}")
    if any(fr.shape != (HEIGHT, WIDTH, 3) or not fr.any()
           for fr in frames.values()):
        raise AssertionError("a dataset frame is empty or misshapen")

    # the packed table (K1b on the card) against the unpacked one
    s, cam = renderer.scene, renderer.camera
    qs, ts = render.se3_to_qt(renderer.poses)
    raw, radius = R.compute_raw_attrs(s.xyz, s.features, qs[1], ts[1], cam)
    _, packed, _ = R.build_keys(raw, radius, s.invalid, cam, renderer.rcfg)
    keys, table, _ = R.build_keys(raw, radius, s.invalid, cam,
                                  dataclasses.replace(renderer.rcfg,
                                                      pack_sort_colors=False))
    bits = lambda a: a.contiguous().view(torch.int32)  # noqa: E731
    rows_ok = all(torch.equal(bits(packed[r]), bits(
        round_bf16(table[r]) if r in (6, 7) else table[r])) for r in range(16))
    tile = R._cfg_tile(renderer.rcfg)
    kw = dict(tile=tile, tiles_x=WIDTH // tile[0], tiles_y=HEIGHT // tile[1],
              rgb_only=True)
    got = blend.blend_forward(packed, keys.tile_start, keys.tile_end, **kw)
    plain = blend.blend_forward_plain(packed, keys.tile_start, keys.tile_end,
                                      **kw)
    torch.cuda.synchronize()
    e_rgb = max_abs(got[..., 0:3], plain[..., 0:3])
    e_pack = max_abs(packed[6:8], table[6:8])
    print(f"  {len(frames)} frames from {json_path.name} "
          f"({'PNG' if has_pil else 'in-memory'} views; poses within "
          f"{e_pose:.3g}); launches {launches}; packed table rows 6-7 are "
          f"round_bf16 of the unpacked ones, the rest equal: {rows_ok} (max "
          f"rounding {e_pack:.3g}); K3 on the packed table vs plain: max|d "
          f"rgb| {e_rgb:.3g} (gate 1e-4)", flush=True)
    if not rows_ok or e_rgb > 1e-4 or e_pack == 0.0:
        raise AssertionError("the packed render is outside its gates")
    return {"dataset_frames": len(frames), "dataset_png": has_pil,
            "dataset_launches": launches, "dataset_pose_err": e_pose,
            "dataset_packed_rgb_err": e_rgb,
            "dataset_pack_rounding": e_pack}


# --- phase 17: the inference benchmark ---------------------------------------

BENCH_VIEWS = 8


def run_inference_benchmark(xyz, feats, K_np, kernels, tmp: Path,
                            card: str) -> dict:
    """Phase 17: ``tools/inference_benchmark.py`` (the port of
    ``benchmark/inference_benchmark.py``) in its reference protocol, 1000
    warm-up and 100 timed frames, on the phase-4 scene as a .ply and a
    dataset .json of BENCH_VIEWS PNG views at 960x544 (``write_views``),
    with the launch counts and the plain versions' calls read around it.
    Fails unless one graph serves the one (H, W) bucket, K1a (capped
    mode), K1b, K2 and K3 launched at its warm-up and capture alone, no
    plain version ran, no frame passed the capacity, and every view's
    replayed frame is the exact eager frame bit for bit. Then traces
    ``tools/profile_attribution.py --rgb-only --fit-cap`` and prints its
    top kernels and stages."""
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import expand
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.tools import (
        inference_benchmark as ib,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.tools import (
        profile_attribution as pa,
    )

    bench_dir = tmp / "inference_benchmark"
    bench_dir.mkdir()
    ply = str(bench_dir / "scene.ply")
    scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                            features=feats, device="cpu"),
                     ply)
    json_path, _, _ = write_views(bench_dir, K_np, BENCH_VIEWS, "cuda")
    args = ib.parse_args(["--scene", ply, "--dataset", str(json_path),
                          "--save_image", str(bench_dir / "frame.png")])
    torch.cuda.synchronize()
    zero_launches(kernels)
    expand.slot_keys.capped_launches = 0
    t0 = time.perf_counter()
    with plain_calls() as plain:
        rec, bench = ib.run(args)
    run_s = time.perf_counter() - t0
    launches = read_launches(kernels)
    capped = expand.slot_keys.capped_launches
    # every view's replayed frame against the exact eager frame
    s = bench.scene
    unequal = []
    for i, (hw, q, t, K) in enumerate(bench.items):
        got = bench.render(i)
        exact = R.rasterize(s.xyz, s.features, s.invalid, q, t,
                            R.Camera(K=K, width=hw[1], height=hw[0]),
                            bench.rcfg, sh_max_band=3,
                            point_object_id=s.object_id).rgb
        if not torch.equal(got, exact):
            unequal.append(i)
    state = {"i": 0}

    def replay():
        i = state["i"] % len(bench.items)
        state["i"] += 1
        bench.render(i)
    per_replay = replay_launches(replay, len(bench.items))
    over = int(bench.over_cap)
    graph_s = [g.capture_s for g in bench.graphs.values()]
    bench.release()
    want = {"slot_keys": 2, "sorted_table": 2, "tile_ranges": 2,
            "blend_forward": 2, "blend_backward": 0,
            "segment_reduce_sorted": 0}
    print(f"  {rec['points']} points, {BENCH_VIEWS} views at {WIDTH}x"
          f"{HEIGHT}: key_cap {rec['key_cap']} (worst probed total "
          f"{rec['worst_key_total']}, headroom 1.1); graphs {rec['graphs']} "
          f"(capture {graph_s} s); {rec['warmup']} warm-up + {rec['iters']} "
          f"timed frames; frames past the capacity {rec['frames_over_cap']}"
          f" (and {over} after the checks); launches {launches}, capped K1a "
          f"{capped}; plain calls {plain}; {BENCH_VIEWS - len(unequal)} of "
          f"{BENCH_VIEWS} replayed frames bit for bit the exact eager frame;"
          f" launches a replay (trace) {per_replay} [{run_s:.1f} s]",
          flush=True)
    print(f"  inference benchmark: {rec['ms']:.4f} ms a frame (host clock; "
          f"CUDA events {rec['event_ms']:.4f}), FPS {rec['fps']:.2f}, "
          f"Mpix/s {rec['mpix_s']:.2f}; {card}", flush=True)
    if (launches != want or capped != 2 or any(plain.values())
            or len(rec["graphs"]) != 1 or rec["frames_over_cap"] or over
            or unequal or per_replay != {"expand_keys": 2, "tile_ranges": 1,
                                         "blend_forward": 1}):
        raise AssertionError("phase 17: the inference benchmark failed its "
                             "checks")
    t0 = time.perf_counter()
    prof = pa.main(["--rgb-only", "--fit-cap",
                    "--out", str(bench_dir / "trace")])
    prof_s = time.perf_counter() - t0
    print(f"  profile_attribution --rgb-only --fit-cap (its seeded scene, "
          f"428,000 points, 1024x544): key_cap {prof['key_cap']}, device "
          f"{prof['device_ms_per_run']:.4f} ms a run; stages "
          f"{ {k: round(v, 4) for k, v in prof['by_stage'].items()} }; top "
          f"kernels {dict(list(prof['by_kernel'].items())[:8])} "
          f"[{prof_s:.1f} s]", flush=True)
    if prof["device_ms_per_run"] <= 0:
        raise AssertionError("phase 17: the profile shows no device time")
    return dict(rec, run_s=run_s, launches=launches,
                capped_slot_keys=capped, plain_calls=dict(plain),
                launches_per_replay=per_replay, capture_s=graph_s,
                card=card, profile={k: prof[k] for k in (
                    "key_cap", "key_total", "device_ms_per_run", "by_stage",
                    "by_kernel")})


# --- phase 9: the scene as a Gaussian mixture, in Fourier space --------------

def run_ftgmm(scene, tmp: Path) -> dict:
    """Phase 9: ``tools/ftgmm.ft_grab_scene`` once on the phase-5 loop's
    final scene (its diagnostic PNGs under ``tmp`` where matplotlib is
    present)."""
    from taichi_3d_gaussian_splatting_tpu_torch.tools.ftgmm import (
        ft_grab_scene,
    )

    vis_dir = tmp / "vis"
    metrics, ms_ = synced_ms(ft_grab_scene, scene, vis_dir=str(vis_dir))
    pngs = sorted(p.name for p in vis_dir.iterdir()) if vis_dir.exists() \
        else []
    print(f"  ft_grab_scene over {int(scene.num_valid())} points: "
          f"{ms_:.1f} ms; {metrics}; plots {pngs}", flush=True)
    if not all(math.isfinite(abs(v)) for v in metrics.values()):
        raise AssertionError(f"ftgmm metrics not finite: {metrics}")
    return {"ftgmm_ms": ms_, "ftgmm_points": int(scene.num_valid()),
            "ftgmm_metrics": {k: [v.real, v.imag] if isinstance(v, complex)
                              else v for k, v in metrics.items()},
            "ftgmm_plots": pngs}


# --- phases 10-13: several ranks on the card ---------------------------------
#
# Each rank is a process that multihost.run_local_ranks spawns (rank
# functions below, at module level so a spawned process can import them).
# Two ranks share the one card, so they run over gloo; a group of one runs
# over NCCL. A rank counts its own kernel launches around each path, so the
# counts are per rank. Times of two ranks on one card measure sharing, not
# scaling.

TP_HEIGHT, TP_WIDTH = 1088, 1920   # Truck's frame cropped to 32-px tiles
GRAD_GATE = (5e-4, 1e-3)          # atol, rtol: the JAX package's gate
B1 = 0.9


def rank_kernels() -> dict:
    """The kernels of the train path by their launch counters."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        blend, expand, histogram, segment_reduce as sr,
    )

    return {"slot_keys": expand.slot_keys,
            "sorted_table": expand.sorted_table,
            "tile_ranges": histogram.tile_ranges,
            "blend_forward": blend.blend_forward,
            "blend_backward": blend.blend_backward,
            "segment_reduce_sorted": sr.segment_reduce_sorted}


def state_leaves(state) -> dict:
    out = {"features": state.scene.features, "xyz": state.scene.xyz,
           "feat_mu": state.feat_opt.mu, "feat_nu": state.feat_opt.nu,
           "pos_mu": state.pos_opt.mu, "pos_nu": state.pos_opt.nu}
    out.update({f"ctrl_{f}": getattr(state.ctrl, f)
                for f in state.ctrl._fields})
    return out


def state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(state_leaves(state).items()):
        h.update(name.encode())
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gate_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| - (atol + rtol |want|): <= 0 inside the
    gradient gate."""
    atol, rtol = GRAD_GATE
    d = (got.double() - want.double()).abs()
    return float((d - (atol + rtol * want.double().abs())).max())


def view_targets(state, feats, camera, pose_ids, cfg_kw) -> list:
    """(gt uint8, q, t, K) of each pose of ``poses()``: targets rendered
    as train_setup's (seeded noise, sigma 0.3, on the DC colours) at that
    pose."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.ops.transforms import (
        se3_to_qt,
    )

    n = feats.shape[0]
    rng = np.random.default_rng(11)
    feats_gt = feats.copy()
    feats_gt[:, [8, 24, 40]] += rng.normal(0.0, 0.3, (n, 3)).astype(
        np.float32)
    dev = state.scene.xyz.device
    fg = torch.from_numpy(feats_gt).to(dev)
    qs, ts = se3_to_qt(torch.from_numpy(poses(max(pose_ids) + 1)).to(dev))
    out = []
    for i in pose_ids:
        q, t = qs[i].contiguous(), ts[i].contiguous()
        rgb = R.rasterize(state.scene.xyz, fg, state.scene.invalid, q, t,
                          camera, R.RasterizerConfig(rgb_only=True,
                                                     **cfg_kw)).rgb
        gt = torch.round(torch.clamp(rgb, 0.0, 1.0) * 255).to(torch.uint8)
        out.append((gt, q, t, camera.K))
    return out


def full_camera(height: int, width: int, dev):
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    f = 580.0 * width / WIDTH
    K = torch.tensor([[f, 0.0, width / 2], [0.0, f, height / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    return R.Camera(K, width, height)


def rank_setup(height=HEIGHT, width=WIDTH):
    """The phase-4 scene and train config on this rank's card."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    R.pin_f32_matmul()
    dev = mh.rank_device("cuda")
    xyz, feats = truck_scene_surround(N_POINTS)
    camera = full_camera(height, width, dev)
    config, step, state, inputs = train_setup(xyz, feats, camera,
                                              {"tile_size": TILE})
    return dev, feats, camera, config, step, state, inputs


def dp_one_rank(loop_ms) -> dict:
    """Phase 10a (a group of one, NCCL): one data-parallel step and one
    single-device step from the same state and view; then, in the same
    group, phase 15 (a) and the NCCL loop of (c) (``dp_window_nccl``;
    ``loop_ms``: phase 5's ms an iteration)."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    setup = rank_setup()
    dev, _, _, config, step, state, inputs = setup
    gt, q, t, K, band = inputs
    dp = make_dp_train_step(config, HEIGHT, WIDTH, device=dev)
    single, m1, _ = step(state, *inputs)
    kernels = rank_kernels()
    torch.cuda.synchronize()
    zero_launches(kernels)
    new, m2, _ = dp(state, gt[None], q[None], t[None], K[None], band)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    a, b = state_leaves(single), state_leaves(new)
    out = {"backend": dist.get_backend(),
           "unequal_leaves": [k for k in a if not torch.equal(a[k], b[k])],
           "losses": [float(m1["loss"]), float(m2["loss"])],
           "launches": launches,
           "collectives": [(c.op, c.numel) for c in dp.collectives]}
    del a, b, single, new, dp
    out["15"] = dp_window_nccl(setup, loop_ms)
    return out


def _collectives_ms(collectives, dev, reps=10) -> float:
    """Host ms of one step's collectives alone (same ops, sizes, dtypes),
    between device syncs: gloo copies CUDA tensors through the host."""
    import torch.distributed as dist

    bufs = [(torch.zeros(c.numel, dtype=c.dtype, device=dev),
             {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[c.op])
            for c in collectives]
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for buf, op in bufs:
            dist.all_reduce(buf, op=op)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _timed_steps(fn, warm: int, timed: int, kernels) -> tuple:
    """(ms a call by CUDA events, launches a call) of fn after warm-up."""
    import torch.distributed as dist

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    dist.barrier()
    zero_launches(kernels)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / timed,
            {k: v / timed for k, v in read_launches(kernels).items()})


def two_ranks(ply: str, cap: int, ref_path: str) -> dict:
    """Phases 10b, 10c, 11 and 12 on this rank of two (gloo, one card),
    then phase 15 (b) and the gloo loop of (c) (``dp_window_gloo``);
    ``ply``: the phase-4 scene as a .ply file, for the renderer; ``cap``
    and ``ref_path``: phase 15 (b)'s capacity and reference."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    rank = mh.rank()
    out = {"backend": dist.get_backend(), "rank": rank}
    kernels = rank_kernels()
    setup = rank_setup()
    dev, feats, camera, config, step, state0, inputs = setup
    gt, q, t, K, band = inputs
    dp = make_dp_train_step(config, HEIGHT, WIDTH, device=dev)

    # 10b: both ranks on the same view, 3 steps, against 3 single steps
    s, ref = state0, state0
    for _ in range(3):
        s, m, _ = dp(s, gt[None], q[None], t[None], K[None], band)
        ref, _, _ = step(ref, *inputs)
    a, b = state_leaves(s), state_leaves(ref)
    out["10b"] = {
        "digest": state_digest(s), "loss": float(m["loss"]),
        "gate_excess": {k: gate_excess(a[k], b[k])
                        for k in ("features", "xyz", "feat_mu", "pos_mu")},
        "max_abs": {k: max_abs(a[k], b[k]) for k in a
                    if k != "ctrl_num_in_camera"},
        "num_in_camera_doubled": bool(torch.equal(
            a["ctrl_num_in_camera"], 2 * b["ctrl_num_in_camera"]))}
    del s, ref, a, b

    # 10c: rank r trains view r (poses()[r]); timed
    (gt_r, q_r, t_r, K_r), = view_targets(state0, feats, camera, [rank],
                                          {"tile_size": TILE})
    cur = {"s": state0}

    def dp_step():
        cur["s"], metrics, _ = dp(cur["s"], gt_r[None], q_r[None],
                                  t_r[None], K_r[None], band)
        return metrics

    ms, launches = _timed_steps(dp_step, 2, 10, kernels)
    coll_ms = _collectives_ms(dp.collectives, dev)
    out["10c"] = {"ms_per_step": ms, "launches_per_step": launches,
                  "collectives": [(c.op, c.numel) for c in dp.collectives],
                  "collectives_ms": coll_ms, "allreduce_share": coll_ms / ms,
                  "digest": state_digest(cur["s"]),
                  "loss": float(dp_step()["loss"])}
    del cur, dp
    torch.cuda.empty_cache()
    out["11"] = tp_phase(kernels)
    torch.cuda.empty_cache()
    out["12"] = render_phase(ply)
    torch.cuda.empty_cache()
    out["15"] = dp_window_gloo(setup, cap, ref_path)
    return out


def tp_phase(kernels) -> dict:
    """Phase 11: the band-parallel step at 1920x1088 (two bands of 17 tile
    rows) against the single-device step at that size."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        make_tp_train_step,
    )

    dev, _, camera, config, step, state0, inputs = rank_setup(
        TP_HEIGHT, TP_WIDTH)
    tp = make_tp_train_step(config, TP_HEIGHT, TP_WIDTH, device=dev)
    zero_launches(kernels)
    new, metrics, aux = tp(state0, *inputs)
    torch.cuda.synchronize()
    first_launches = read_launches(kernels)
    band_keys = aux["band_keys"]
    single, m1, aux1 = step(state0, *inputs)
    grads = {k: gate_excess(aux[k], aux1[k])
             for k in ("grad_features", "grad_xyz")}
    a, b = state_leaves(new), state_leaves(single)
    res = {"band_keys": band_keys, "num_keys": int(metrics["num_keys"]),
           "single_num_keys": int(m1["num_keys"]),
           "losses": [float(metrics["loss"]), float(m1["loss"])],
           "grad_gate_excess": grads,
           "mu_gate_excess": {k: gate_excess(a[k], b[k])
                              for k in ("feat_mu", "pos_mu")},
           "max_abs": {k: max_abs(a[k], b[k]) for k in a},
           "num_in_camera_equal": bool(torch.equal(
               a["ctrl_num_in_camera"], b["ctrl_num_in_camera"])),
           "pred_max_abs": max_abs(aux["pred"], aux1["pred"]),
           "launches_first_step": first_launches,
           "digest": state_digest(new)}
    del new, single, aux, aux1
    cur = {"s": state0}

    def tp_step():
        cur["s"], _, _ = tp(cur["s"], *inputs)

    res["ms_per_step"], res["launches_per_step"] = _timed_steps(
        tp_step, 1, 5, kernels)
    res["collectives"] = [(c.op, c.numel) for c in tp.collectives]
    return res


def render_phase(ply: str) -> dict:
    """Phase 12: ``apps/render.py``'s renderer on two ranks, pose-sharded
    (its uint8 frames) and band-split at 960x544 (576 rows rendered,
    cropped to 544: rank 0's float frames against its own single-device
    render)."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.tile_parallel import (
        rasterize_band_sharded,
    )

    kernels = {k: v for k, v in rank_kernels().items()
               if k in ("slot_keys", "sorted_table", "tile_ranges",
                        "blend_forward")}
    K_np = np.asarray([[580.0, 0.0, WIDTH / 2], [0.0, 580.0, HEIGHT / 2],
                       [0.0, 0.0, 1.0]], np.float32)
    pose_list = poses(9)
    res = {}
    for mode in ("data_parallel", "tile_parallel"):
        cfg = render.RendererConfig(parquet_paths=[ply], image_height=HEIGHT,
                                    image_width=WIDTH, camera_intrinsics=K_np,
                                    **{mode: True})
        renderer = render.GaussianPointRenderer(cfg, pose_list, device="cuda")
        torch.cuda.synchronize()
        zero_launches(kernels)
        t0 = time.perf_counter()
        frames = dict(renderer.frames())
        torch.cuda.synchronize()
        res[mode] = {"frames": frames, "s": time.perf_counter() - t0,
                     "launches": read_launches(kernels)}
    # the band render's float frames against the single-device render
    s = renderer.scene
    qs, ts = render.se3_to_qt(renderer.poses)
    band = TILE * mh.world_size()
    worst = {"rgb": 0.0}
    for i in range(len(pose_list)):
        out = rasterize_band_sharded(s.xyz, s.features, s.invalid, qs[i],
                                     ts[i], renderer.camera, renderer.rcfg,
                                     point_object_id=s.object_id)
        ref = renderer.render(qs[i], ts[i])
        worst["rgb"] = max(worst["rgb"], max_abs(
            torch.clamp(out.rgb, 0.0, 1.0), ref))
    full = R.RasterizerConfig(tile_size=TILE)
    out = rasterize_band_sharded(s.xyz, s.features, s.invalid, qs[1], ts[1],
                                 renderer.camera, full,
                                 point_object_id=s.object_id)
    ref = R.rasterize(s.xyz, s.features, s.invalid, qs[1], ts[1],
                      renderer.camera, full, point_object_id=s.object_id)
    for f in ("alpha", "depth"):
        worst[f] = max_abs(getattr(out, f), getattr(ref, f))
    worst["count_differs"] = int((out.count != ref.count).sum())
    res["tile_parallel"]["float_max_abs"] = worst
    res["padded_height"] = -(-HEIGHT // band) * band
    return res


def mh_rank() -> dict:
    """Phase 13: parallel/mh_smoke.py's worker on this rank of two (the
    group is formed already, so ``run_worker`` joins it as it is)."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import mh_smoke
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    kernels = rank_kernels()
    zero_launches(kernels)
    res = mh_smoke.run_worker(None, 2, mh.rank(), 2, None, device="cuda")
    torch.cuda.synchronize()
    res["launches"] = read_launches(kernels)
    return res


def run_multi_rank(xyz, feats, frames: dict, tmp: Path, phase,
                   loop_ms) -> dict:
    """Phases 10-13 (rank functions above), checked against their gates;
    ``frames``: phase 2's uint8 frames of ``poses(9)``; ``loop_ms``: phase
    5's ms an iteration. The same spawned ranks then run phase 15's work
    (each process costs seconds to reach the card); its record is
    ``out["dp_windows"]``, checked by ``check_dp_windows``."""
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import mh_smoke
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    out = {}
    phase("phase 10: data-parallel train steps at full width")
    t0 = time.perf_counter()
    (one,) = mh.run_local_ranks(dp_one_rank, 1, args=(loop_ms,),
                                device="cuda", timeout_s=600)
    windows = {"nccl": one.pop("15")}
    print(f"  10a (1 rank, {one['backend']}): losses {one['losses']}, "
          f"leaves unequal to the single-device step {one['unequal_leaves']}"
          f", launches {one['launches']}, collectives {one['collectives']} "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)
    if one["backend"] != "nccl" or one["unequal_leaves"]:
        raise AssertionError("10a: the DP step over NCCL is not the "
                             "single-device step bit for bit")
    if any(v != 1 for v in one["launches"].values()):
        raise AssertionError(f"10a launches {one['launches']}")
    out["dp_world1"] = one

    ply = str(tmp / "scene12.ply")
    scene_lib.to_ply(scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                            features=feats, device="cpu"),
                     ply)
    ref_path = str(tmp / "ref15b.pt")
    cap = dp_window_reference(xyz, feats, ref_path)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mh.run_local_ranks(two_ranks, 2, args=(ply, cap, ref_path),
                               device="cuda", timeout_s=900)
    secs = time.perf_counter() - t0
    windows["gloo"] = [r.pop("15") for r in ranks]
    windows["gloo_cap"] = cap
    out["dp_windows"] = windows
    if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
        raise AssertionError("two ranks on one card must run over gloo")
    b = [r["10b"] for r in ranks]
    print(f"  10b (2 ranks, same view, 3 steps): digests equal "
          f"{b[0]['digest'] == b[1]['digest']}, gate excess "
          f"{b[0]['gate_excess']}, max |d| {b[0]['max_abs']}", flush=True)
    if b[0]["digest"] != b[1]["digest"]:
        raise AssertionError("10b: the ranks' states differ")
    if max(b[0]["gate_excess"].values()) > 0 or not b[0][
            "num_in_camera_doubled"]:
        raise AssertionError("10b: outside the gradient gate")
    c = [r["10c"] for r in ranks]
    print(f"  10c (2 ranks, views 0 and 1, sharing one card): "
          f"{[x['ms_per_step'] for x in c]} ms a step, collectives "
          f"{[x['collectives_ms'] for x in c]} ms ({c[0]['collectives']}), "
          f"share {[x['allreduce_share'] for x in c]}, launches a step "
          f"{[x['launches_per_step'] for x in c]}", flush=True)
    if c[0]["digest"] != c[1]["digest"]:
        raise AssertionError("10c: the ranks' states differ")
    for x in c:
        if any(v != 1 for v in x["launches_per_step"].values()):
            raise AssertionError(f"10c launches {x['launches_per_step']}")
    out["dp_two_ranks"] = {"same_view": b[0], "two_views": c}

    phase("phase 11: band-parallel train step at 1920x1088")
    tp = [r["11"] for r in ranks]
    print(f"  band keys {[x['band_keys'] for x in tp]} (single-device "
          f"{tp[0]['single_num_keys']}), losses {tp[0]['losses']}, grad "
          f"gate excess {tp[0]['grad_gate_excess']}, mu {tp[0]['mu_gate_excess']}"
          f", pred {tp[0]['pred_max_abs']:.3g}; {[x['ms_per_step'] for x in tp]}"
          f" ms a step, launches a step {[x['launches_per_step'] for x in tp]}",
          flush=True)
    if tp[0]["digest"] != tp[1]["digest"]:
        raise AssertionError("11: the ranks' states differ")
    if (max(tp[0]["grad_gate_excess"].values()) > 0
            or max(tp[0]["mu_gate_excess"].values()) > 0
            or not tp[0]["num_in_camera_equal"]
            or tp[0]["pred_max_abs"] > 1e-4):
        raise AssertionError("11: outside the gradient gate")
    for x in tp:
        if x["band_keys"] < 1 or any(
                v != 1 for v in x["launches_per_step"].values()):
            raise AssertionError(f"11: band keys {x['band_keys']}, "
                                 f"launches {x['launches_per_step']}")
    out["tp"] = tp

    phase("phase 12: the render app on two ranks")
    r12 = [r["12"] for r in ranks]
    dp_frames = {}
    for r in r12:
        dp_frames.update(r["data_parallel"]["frames"])
    if sorted(dp_frames) != sorted(frames):
        raise AssertionError(f"12: data-parallel frames {sorted(dp_frames)}")
    bad = [i for i in frames if not np.array_equal(dp_frames[i], frames[i])]
    tp_frames = r12[0]["tile_parallel"]["frames"]
    fl = r12[0]["tile_parallel"]["float_max_abs"]
    print(f"  data_parallel: {[sorted(r['data_parallel']['frames']) for r in r12]}"
          f" frames by rank, {len(bad)} differ from phase 2's; launches "
          f"{[r['data_parallel']['launches'] for r in r12]}; tile_parallel: "
          f"{len(tp_frames)} frames on rank 0 ({r12[0]['padded_height']} rows"
          f" rendered), float max |d| {fl}; launches "
          f"{[r['tile_parallel']['launches'] for r in r12]} "
          f"[{secs:.1f} s for phases 10b-12 and 15b]", flush=True)
    if bad:
        raise AssertionError(f"12: data-parallel frames {bad} differ")
    if (sorted(tp_frames) != sorted(frames) or r12[1]["tile_parallel"][
            "frames"] or any(f.shape != (HEIGHT, WIDTH, 3)
                             for f in tp_frames.values())):
        raise AssertionError("12: tile-parallel frames")
    if (fl["rgb"] > 1e-4 or fl["alpha"] > 1e-4 or fl["depth"] > 5e-4
            or fl["count_differs"] > 1e-4 * HEIGHT * WIDTH):
        raise AssertionError("12: band render outside the image gate")
    for rank, r in enumerate(r12):
        # pose-sharded frames are one graph's replays (K1-K3 launch at its
        # warm-up and capture); the bands size their keys exactly
        n_dp = 2 if r["data_parallel"]["frames"] else 0
        if (any(v != n_dp for v in r["data_parallel"]["launches"].values())
                or any(v != len(frames) for v in r["tile_parallel"][
                    "launches"].values())):
            raise AssertionError(f"12: rank {rank} launches")
    for r in r12:
        for mode in ("data_parallel", "tile_parallel"):
            r[mode]["frames"] = sorted(r[mode]["frames"])
    out["render"] = r12

    phase("phase 13: mh_smoke, two processes against one")
    mh_ranks = mh.run_local_ranks(mh_rank, 2, device="cuda", timeout_s=600)
    ref = mh_smoke.single_process_reference(2, device="cuda")
    got = mh_ranks[0]
    excess = {k: gate_excess(torch.from_numpy(got[k]) / (1 - B1),
                             torch.from_numpy(ref[k]) / (1 - B1))
              for k in ("feat_mu", "pos_mu")}
    res13 = {"losses": got["losses"].tolist(),
             "ref_losses": ref["losses"].tolist(), "mu_gate_excess": excess,
             "features_max_abs": float(np.abs(got["features"]
                                              - ref["features"]).max()),
             "xyz_max_abs": float(np.abs(got["xyz"] - ref["xyz"]).max()),
             "launches": [r["launches"] for r in mh_ranks]}
    print(f"  {res13}", flush=True)
    if (not np.allclose(got["losses"], ref["losses"], rtol=1e-5, atol=0)
            or max(excess.values()) > 0
            or not np.array_equal(got["num_in_camera"], ref["num_in_camera"])
            or not np.array_equal(mh_ranks[1]["features"], got["features"])):
        raise AssertionError("13: outside the gradient gate")
    steps_rows = 2 * mh_smoke.TOTAL_DEVICES // 2
    for r in mh_ranks:
        if any(v != steps_rows for v in r["launches"].values()):
            raise AssertionError(f"13: launches {r['launches']}")
    out["mh_smoke"] = res13
    return out


# --- phase 14: windowed training ---------------------------------------------

WINDOW = 8               # steps a window (steps_per_dispatch)
OVERFLOW_CAP = 2 ** 18   # a key capacity below the full-width frame's total
# each TPU kernel's CUDA kernels, by symbol (K1 is two)
WINDOW_SYMBOLS = {"expand_keys": ("slot_keys_kernel", "sorted_table_kernel"),
                  "tile_ranges": ("tile_ranges_kernel",),
                  "blend_forward": ("blend_forward_kernel",),
                  "blend_backward": ("blend_backward_kernel",),
                  "segment_reduce": ("segment_reduce_kernel",)}


def leaves_equal(a, b) -> bool:
    from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint

    return all(torch.equal(x, y) for x, y in zip(checkpoint.state_leaves(a),
                                                 checkpoint.state_leaves(b)))


def window_profile(run, reps: int) -> tuple:
    """A profiler window of reps calls of ``run`` (one replay each): the
    device's busy share, each TPU kernel's launches a call counted from
    the trace (the wrappers' counters do not tick under a replay), and its
    device ms a launch under replay (K1: K1a + K1b)."""
    expect = tuple(s + "(" for syms in WINDOW_SYMBOLS.values()
                   for s in syms)
    wall_ms, calls = profiled(run, reps, expect)
    busy_ms = sum(us for _, us, _ in calls) * reps / 1e3
    launches, kernel_ms_ = {}, {}
    for name, syms in WINDOW_SYMBOLS.items():
        mine = [(us, k) for ev, us, k in calls
                if any(s + "(" in ev for s in syms)]
        launches[name] = sum(k for _, k in mine)
        kernel_ms_[name] = (sum(us for us, _ in mine) / 1e3
                            / max(launches[name], 1) * len(syms))
    by_name = {}  # names cut to 90 characters; kernels that share one add up
    for ev, us, _ in calls:
        by_name[ev[:90]] = by_name.get(ev[:90], 0.0) + us / 1e3
    top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
    # the collectives' device events (NCCL's kernels), launches a call
    nccl = {ev[:90]: k for ev, _, k in calls if "nccl" in ev.lower()}
    return {"window_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "kernel_ms_under_replay": kernel_ms_,
            "top_kernels_ms_per_window": dict(top),
            "nccl_launches_per_window": nccl}, launches


def run_windowed(xyz, feats, camera, cfg_kw, ref: dict) -> dict:
    """Phase 14 (a)-(c): windows of WINDOW steps through make_train_step
    (scan_steps) on phase 4's scene and start state over WINDOW views,
    each window one CUDA graph replay. ``ref``: phase 4's figures of this
    run (step ms, device ms), for the record."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import (
        expand, histogram, stages,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    config, step, start, (gt0, q0, t0, K, band) = train_setup(
        xyz, feats, camera, cfg_kw)
    views = view_targets(start, feats, camera, list(range(WINDOW)), cfg_kw)
    imgs, qs, ts = (torch.stack([v[i] for v in views]) for i in range(3))
    Ks = torch.stack([v[3] for v in views])
    # (a) WINDOW eager steps on the exact path, then the window's replays
    eager, losses, totals = start, [], []
    for i in range(WINDOW):
        eager, m, _ = step(eager, imgs[i], qs[i], ts[i], K, band)
        losses.append(m["loss"])
        totals.append(m["num_keys"])
    cap = trainer.fit_key_cap(max(totals))
    window = trainer.make_train_step(config, HEIGHT, WIDTH,
                                     scan_steps=WINDOW, device="cuda",
                                     key_cap=cap)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    histogram.tile_counts.launches = 0
    (got, wm, _), first_ms = synced_ms(window, start, imgs, qs, ts, Ks,
                                       band)
    # the tile counters: one launch a step's build_keys in the capture, none
    # in the warm-up (it counts the counters' slots)
    counter_launches = histogram.tile_counts.launches
    if counter_launches != WINDOW:
        raise AssertionError(f"tile_counts launched {counter_launches} times "
                             f"in the capture of {WINDOW} steps")
    (graph,) = window.graphs.values()
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    first_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    same = leaves_equal(got, eager) and torch.equal(wm["loss"],
                                                    torch.stack(losses))
    # a second replay from the start state: the state is copied in anew
    again, wm2, _ = window(start, imgs, qs, ts, Ks, band)
    same2 = leaves_equal(again, eager) and torch.equal(wm2["loss"],
                                                       torch.stack(losses))
    print(f"  (a) {WINDOW} views, key totals {totals} -> key_cap {cap}; "
          f"the window against {WINDOW} eager exact steps: state and losses "
          f"bit for bit {same} (replayed again from the start: {same2}); "
          f"first call (warm-up, capture, replay) {first_ms:.1f} ms, of "
          f"which capture {graph.capture_s:.3f} s; pool {pool_gib:.3f} GiB "
          f"reserved, peak {first_peak_gib:.3f} GiB allocated through "
          f"warm-up, capture and a replay", flush=True)
    if not (same and same2):
        raise AssertionError("the window differs from the eager steps")

    # (b) a capacity below the key total: capped K1a against its capped
    # plain version, and the capped step against the capped plain route
    frame = Frame(start.scene.xyz, start.scene.features, start.scene.invalid,
                  q0, t0, camera, R.RasterizerConfig(**cfg_kw))
    total = frame.expand_kw["total"]
    key_total = torch.tensor(total, dtype=torch.int64, device="cuda")
    k1a = {}
    for c in (OVERFLOW_CAP, trainer.fit_key_cap(total)):
        kw = dict(frame.expand_kw, total=c)
        fused, owner = expand.slot_keys(*frame.expand_args, **kw,
                                        key_total=key_total)
        fused_p, owner_p = expand.slot_keys_plain(*frame.expand_args, **kw,
                                                  key_total=key_total)
        k1a[c] = bool(torch.equal(fused, fused_p)
                      and torch.equal(owner, owner_p))
    capped = trainer.make_train_step(config, HEIGHT, WIDTH, device="cuda",
                                     key_cap=OVERFLOW_CAP)
    _, mk, ak = capped(start, gt0, q0, t0, K, band)
    with plain_route():
        _, mp, ap = capped(start, gt0, q0, t0, K, band)
    exact_loss = float(step(start, gt0, q0, t0, K, band)[1]["loss"])
    overflow = {
        "key_total": int(mk["num_keys"]), "key_cap": OVERFLOW_CAP,
        "loss": float(mk["loss"]),
        "plain_loss": float(mp["loss"]), "exact_loss": exact_loss,
        "pred_err": max_abs(ak["pred"], ap["pred"]),
        "grad_features_excess": gate_excess(ak["grad_features"],
                                            ap["grad_features"]),
        "grad_xyz_excess": gate_excess(ak["grad_xyz"], ap["grad_xyz"]),
        "k1a_bit_for_bit": {str(c): v for c, v in k1a.items()}}
    print(f"  (b) key total {total}: capped K1a at {OVERFLOW_CAP} and "
          f"{trainer.fit_key_cap(total)} bit for bit against its plain "
          f"version {k1a}; the step at {OVERFLOW_CAP} against the plain "
          f"route: {overflow}", flush=True)
    if not all(k1a.values()):
        raise AssertionError("capped K1a differs from its plain version")
    if (int(mk["num_keys"]) != total or int(mp["num_keys"]) != total
            or abs(overflow["loss"] - overflow["plain_loss"])
            > 1e-4 * abs(overflow["plain_loss"])
            or overflow["pred_err"] > 1e-4
            or overflow["grad_features_excess"] > 0
            or overflow["grad_xyz_excess"] > 0
            or overflow["loss"] == exact_loss):
        raise AssertionError("the capped step is outside the gates of the "
                             "capped plain route, or dropped no key")

    # (c) timing: warm replays, each from the static state it returned
    state = got

    def run():
        nonlocal state
        state = window(state, imgs, qs, ts, Ks, band)[0]
    window_ms = cuda_ms(run, reps=10, warmup=1) / WINDOW
    stages.reset()
    busy, launches = window_profile(run, reps=3)
    counts = stages.read().counts
    records = stages._count_records["tiles_nonempty"]
    num_tiles = (HEIGHT // TILE) * (WIDTH // TILE)
    print(f"  (c) tile counters of the traced replays, a mean over {records} "
          f"steps: {counts}", flush=True)
    if (set(counts) != set(histogram.TILE_COUNTS) or records == 0
            or records % WINDOW
            or not 0 < counts["tile_keys_max"] <= counts["tile_keys_kept"]
            <= cap or not 0 < counts["tiles_nonempty"] <= num_tiles):
        raise AssertionError(f"the window's tile counters {counts} over "
                             f"{records} steps")
    per_step_device = busy["device_busy_ms"] / 3 / WINDOW
    print(f"  (c) {window_ms:.3f} ms a step over warm replays (phase 4: "
          f"{ref.get('step_ms')} ms a step, {ref.get('device_ms')} ms of "
          f"device work); device {per_step_device:.3f} ms a step, busy "
          f"{busy['busy_share']:.3f}; launches a window from the trace "
          f"{launches}; {busy}", flush=True)
    for name, n in launches.items():
        if n != WINDOW * len(WINDOW_SYMBOLS[name]):
            raise AssertionError(f"{name}: {n} launches in a window of "
                                 f"{WINDOW} steps")
    if not all(math.isfinite(float(v)) for v in wm["loss"]):
        raise AssertionError("a non-finite window loss")
    return {"window_steps": WINDOW, "window_key_cap": cap,
            "window_tile_counts_launches": counter_launches,
            "window_tile_counters": counts,
            "window_key_totals": totals,
            "window_bit_for_bit": same and same2,
            "window_losses": [float(v) for v in wm["loss"]],
            "window_capture_s": graph.capture_s,
            "window_first_call_ms": first_ms,
            "window_pool_reserved_gib": pool_gib,
            "window_first_call_peak_gib": first_peak_gib,
            "window_ms_per_step": window_ms,
            "window_device_ms_per_step": per_step_device,
            "window_profile": busy, "window_launches": launches,
            "window_phase4_step_ms": ref.get("step_ms"),
            "window_phase4_device_ms": ref.get("device_ms"),
            "window_overflow": overflow}


def record_windows(trainer, memory: bool = False) -> list:
    """Wrap the trainer's ``_get_step`` so that each window call appends a
    row: its size, SH band and key capacity, whether it captured a graph
    and the graphs every window of the trainer holds after it. With
    ``memory``, also the card's memory before and after the call, each
    read after ``empty_cache`` (what the process holds, not the
    allocator's free cache)."""
    rows = []
    get_step = trainer._get_step

    def held_gib():
        # no collector: a window the trainer drops frees its graph at once
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 2 ** 30

    def recorded(h, w, scan_steps=0):
        fn = get_step(h, w, scan_steps)
        if scan_steps == 0:
            return fn

        def call(state, *a):
            row = {"size": [h, w], "sh_band": int(a[4]),
                   "key_cap": trainer._key_cap}
            if memory:
                row["held_before_gib"] = held_gib()
            captures = fn.captures
            out = fn(state, *a)
            row.update(captured=fn.captures > captures, graphs_held=sum(
                len(getattr(f, "graphs", {}))
                for f in trainer._step_cache.values()))
            if memory:
                row["held_after_gib"] = held_gib()
            rows.append(row)
            return out
        return call

    trainer._get_step = recorded
    return rows


def run_window_loop(xyz, feats, K_np, loop_ms, dev="cuda",
                    label="(d)", **over) -> dict:
    """Phase 14 (d): phase 5's loop with steps_per_dispatch WINDOW: its
    windows, the graphs they capture and hold, its key-capacity refits, ms
    an iteration over the whole train() window, then a resume from
    checkpoint_latest. ``over``: more config fields (phase 15 (c):
    ``multihost``)."""
    from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint

    views = loop_views(K_np, dev)
    saved_as = []
    Trainer = loop_trainer_class(views[:6], views[6:], xyz, feats, saved_as)
    log_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(loop_config(log_dir.name, steps_per_dispatch=WINDOW,
                                  **over), device=dev)
    refits, saves = [], {}
    rebucket = trainer._maybe_rebucket_key_cap
    windows = record_windows(trainer)

    def recorded_rebucket(num_keys):
        before = trainer._key_cap
        grew = rebucket(num_keys)
        refits.append({"live_keys": num_keys, "key_cap_before": before,
                       "key_cap_after": trainer._key_cap})
        return grew

    save = checkpoint.save_checkpoint

    def recorded_save(path, state, meta):
        save(path, state, meta)
        # the windows' state lives in their graphs' buffers, which later
        # replays overwrite: keep a copy of what was saved
        saves.update(leaves=[t.clone() for t in
                             checkpoint.state_leaves(state)], meta=meta)

    trainer._maybe_rebucket_key_cap = recorded_rebucket
    checkpoint.save_checkpoint = recorded_save
    try:
        state, train_ms = synced_ms(trainer.train)
    finally:
        checkpoint.save_checkpoint = save
    loop_w_ms = train_ms / LOOP_ITERS
    keys = {(tuple(r["size"]), r["sh_band"], r["key_cap"]) for r in windows}
    saved_it = int(saves["meta"]["iteration"])
    resumed = Trainer(loop_config(
        log_dir.name + "/resumed", steps_per_dispatch=WINDOW,
        num_iterations=saved_it + 1,
        resume_from=str(Path(log_dir.name) / "checkpoint_latest"), **over),
        device=dev)
    restored = resumed.train()
    same = all(torch.equal(a, b) for a, b in zip(
        checkpoint.state_leaves(restored), saves["leaves"]))
    same_cap = resumed._key_cap == saves["meta"]["key_cap"]
    print(f"  {label} {LOOP_ITERS} iterations with steps_per_dispatch {WINDOW}: "
          f"{loop_w_ms:.2f} ms an iteration over the whole train() window "
          f"(phase 5: {loop_ms} ms); windows {windows}; refits {refits}; "
          f"resumed at {saved_it + 1}: leaves equal {same}, key_cap "
          f"{resumed._key_cap} restored {same_cap}", flush=True)
    if len(windows) < 2 or any(r["graphs_held"] != 1 for r in windows):
        raise AssertionError(f"the loop ran {len(windows)} windows, or held "
                             f"other than one graph after one: {windows}")
    if sum(r["captured"] for r in windows) != len(keys):
        raise AssertionError(f"{len(keys)} (size, band, capacity) keys but "
                             f"other captures: {windows}")
    if not (same and same_cap):
        raise AssertionError("the resumed state differs from the saved one")
    if not bool(torch.isfinite(state.scene.features).all()):
        raise AssertionError("non-finite features after the loop")
    log_dir.cleanup()
    return {"window_loop_ms_per_iteration": loop_w_ms,
            "window_loop_phase5_ms": loop_ms,
            "window_loop_windows": windows,
            "window_loop_refits": refits,
            "window_loop_resume_equal": same and same_cap}


# the schedule of phase 14 (e): windows 1-8 and 9-16 at SH band 0, 17-24
# and 25-32 at band 1 (480x256), densify after each; 41-48 at 960x544
REUSE_ITERS = 49
REUSE_WINDOWS = [(0, 0), (0, 0), (0, 1), (0, 1), (1, 2)]  # (size, band)


def run_window_reuse(xyz, feats, K_np, dev="cuda") -> dict:
    """Phase 14 (e): a loop whose windows replay a cached graph after a
    densify round (partial copy-in of the new scene and controller) and
    after an SH-band change (the window's one graph released and captured
    anew), then change size (the trainer drops the old size's windows),
    with the memory the process holds before and after each window."""
    views = loop_views(K_np, dev)
    Trainer = loop_trainer_class(views[:6], views[6:], xyz, feats, [])
    log_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(loop_config(
        log_dir.name, steps_per_dispatch=WINDOW, num_iterations=REUSE_ITERS,
        val_interval=40, half_downsample_factor_interval=33,
        increase_color_max_sh_band_interval=17,
        adaptive_controller_config={
            "num_iterations_warm_up": 8, "num_iterations_densify": 8,
            "num_iterations_reset_alpha": 1000,
            "densification_view_space_position_gradients_threshold": 1e-12,
        }), device=dev)
    windows = record_windows(trainer, memory=True)
    densify_after = []  # windows run before each densify round
    apply = trainer.densify_apply

    def densify_apply(scene, info, generator):
        densify_after.append(len(windows))
        return apply(scene, info, generator)

    trainer.densify_apply = densify_apply
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    state, loop_ms = synced_ms(trainer.train)
    peak_reserved = torch.cuda.max_memory_reserved() / 2 ** 30
    peak_allocated = torch.cuda.max_memory_allocated() / 2 ** 30
    sizes = sorted({tuple(r["size"]) for r in windows})
    got = [(sizes.index(tuple(r["size"])), r["sh_band"]) for r in windows]
    before = [r["held_before_gib"] for r in windows]
    # one half-size graph held before windows 2 and 4 alike (its first
    # capture's growth, from held0, is the scale)
    growth = before[3] - before[1] if len(before) > 3 else float("nan")
    print(f"  (e) {REUSE_ITERS} iterations, windows (size, band) {got}, "
          f"densify rounds after windows {densify_after}; {windows}; held "
          f"{held0:.3f} GiB before train(), growth from before window 2 to "
          f"before window 4 (a band change between) {growth:.3f} GiB; peak "
          f"reserved {peak_reserved:.3f} GiB, allocated "
          f"{peak_allocated:.3f} GiB; {loop_ms:.1f} ms", flush=True)
    if got != REUSE_WINDOWS or [r["captured"] for r in windows] \
            != [True, False, True, False, True] or any(
                r["graphs_held"] != 1 for r in windows):
        raise AssertionError("the windows did not replay, recapture and "
                             f"release as scheduled: {windows}")
    if not {1, 3} <= set(densify_after):
        raise AssertionError("no densify round before the replays of "
                             f"windows 2 and 4: {densify_after}")
    if not growth < 0.5 * (before[1] - held0):
        raise AssertionError(f"the memory held grew by {growth:.3f} GiB "
                             "across a band change")
    if not bool(torch.isfinite(state.scene.features).all()):
        raise AssertionError("non-finite features after the loop")
    log_dir.cleanup()
    return {"window_reuse_windows": windows,
            "window_reuse_densify_after": densify_after,
            "window_reuse_held0_gib": held0,
            "window_reuse_band_change_growth_gib": growth,
            "window_reuse_peak_reserved_gib": peak_reserved,
            "window_reuse_peak_allocated_gib": peak_allocated,
            "window_reuse_loop_ms": loop_ms}


# --- phase 15: data-parallel windows ------------------------------------------

DP_WINDOW_B = 4          # steps of phase 15 (b)'s window on two gloo ranks
GLOO_LOOP_ITERS = 20     # phase 15 (c)'s loop on two gloo ranks


def full_K_np() -> np.ndarray:
    return np.asarray([[580.0, 0.0, WIDTH / 2], [0.0, 580.0, HEIGHT / 2],
                       [0.0, 0.0, 1.0]], np.float32)


def window_rows(views, rows) -> list:
    """(images f32, qs, ts, Ks), each (steps, len(row), ...): step s takes
    the views ``rows[s]``; the targets widened to f32 as the step widens
    uint8 (the trainer stages a data-parallel dispatch's targets as f32)."""
    def take(i):
        return torch.stack([torch.stack([views[v][i] for v in row])
                            for row in rows])
    return [take(0).to(torch.float32) * (1.0 / 255.0), take(1), take(2),
            take(3)]


def eager_key_cap(step, start, views, band) -> int:
    """Phase 14a's capacity: ``fit_key_cap`` of the largest key total over
    WINDOW eager exact steps from ``start``, one on each of ``views``."""
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    state, totals = start, []
    for gt, q, t, K in views[:WINDOW]:
        state, m, _ = step(state, gt, q, t, K, band)
        totals.append(m["num_keys"])
    return trainer.fit_key_cap(max(totals))


def dp_window_nccl(setup, loop_ms) -> dict:
    """Phase 15 (a) and the loop of (c), in a group of one over NCCL
    (``setup``: ``rank_setup()``'s): the data-parallel window of WINDOW
    steps (one row a step) at phase 14a's capacity against phase 14a's
    single-device window and WINDOW eager capped data-parallel steps from
    the same state on the same f32 targets, its replays timed and traced;
    phase 10a's eager step timed; then phase 14d's loop with
    ``multihost`` (this process is the group's one rank); last, (d): the
    group left through ``multihost.shutdown()`` with 15a's window alive
    (``release_check``)."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training import (
        checkpoint,
        trainer,
    )

    t0 = time.perf_counter()
    dev, feats, camera, config, step, start, inputs = setup
    band = inputs[4]
    views = view_targets(start, feats, camera, list(range(WINDOW)),
                         {"tile_size": TILE})
    cap = eager_key_cap(step, start, views, band)
    rows = window_rows(views, [[i] for i in range(WINDOW)])
    # phase 14a's single-device window, on the same f32 targets
    single = trainer.make_train_step(config, HEIGHT, WIDTH,
                                     scan_steps=WINDOW, device=dev,
                                     key_cap=cap)
    s1, m1, _ = single(start, *(x[:, 0] for x in rows), band)
    ref = [t.clone() for t in checkpoint.state_leaves(s1)]
    ref_losses = m1["loss"].clone()
    del single, s1, m1
    gc.collect()
    torch.cuda.empty_cache()

    def same(state, losses) -> bool:
        return (all(torch.equal(a, b) for a, b in zip(
            checkpoint.state_leaves(state), ref))
            and torch.equal(losses, ref_losses))

    capped = make_dp_train_step(config, HEIGHT, WIDTH, device=dev,
                                key_cap=cap)
    eager, losses = start, []
    for i in range(WINDOW):
        eager, m, _ = capped(eager, *(x[i] for x in rows), band)
        losses.append(m["loss"])
    eager_same = same(eager, torch.stack(losses))
    collectives = [(c.op, c.numel) for c in capped.collectives]
    del eager, capped
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    window = make_dp_train_step(config, HEIGHT, WIDTH, device=dev,
                                scan_steps=WINDOW, key_cap=cap)
    reserved0 = torch.cuda.memory_reserved()
    (got, wm, fs), first_ms = synced_ms(window, start, *rows, band)
    pool_gib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    torch.cuda.empty_cache()
    # what the window itself holds: its pool, static buffers and outputs
    held_gib = (torch.cuda.memory_reserved() - reserved0) / 2 ** 30
    same1 = same(got, wm["loss"])
    again, wm2, _ = window(start, *rows, band)  # replayed from the start
    same2 = same(again, wm2["loss"])
    (graph,) = window.graphs.values()
    state = again

    def run():
        nonlocal state
        state = window(state, *rows, band)[0]
    window_ms = cuda_ms(run, reps=10, warmup=1) / WINDOW
    busy, launches = window_profile(run, reps=3)
    a = {"mode": window.mode, "captures": window.captures,
         "graphs": len(window.graphs), "backend": dist.get_backend(),
         "cap": cap, "eager_steps_equal": eager_same, "window_equal": same1,
         "replay_equal": same2, "losses": [float(v) for v in wm["loss"]],
         "finite_frame": bool(torch.isfinite(fs["pred"]).all()),
         "first_call_ms": first_ms, "capture_s": graph.capture_s,
         "pool_gib": pool_gib, "held_gib": held_gib,
         "ms_per_step": window_ms,
         "device_ms_per_step": busy["device_busy_ms"] / 3 / WINDOW,
         "profile": busy, "launches": launches, "collectives": collectives}
    # the window stays alive (tracked) through 15c, for the release of 15d
    del got, again, state, fs, wm, wm2
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # phase 10a's path: the eager data-parallel step, exact sizing, timed
    exact = make_dp_train_step(config, HEIGHT, WIDTH, device=dev)
    cur = {"s": start}

    def dp_step():
        cur["s"] = exact(cur["s"], *(x[0] for x in rows), band)[0]
    a["eager_dp_step_ms"] = cuda_ms(dp_step, reps=5, warmup=2)
    a["seconds"] = time.perf_counter() - t0
    del cur, exact
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    xyz, feats_l = truck_scene_surround(N_POINTS)
    loop = run_window_loop(xyz, feats_l, full_K_np(), loop_ms, dev,
                           label="(c) NCCL, one rank,", multihost=True)
    loop["seconds"] = time.perf_counter() - t0
    return {"a": a, "c": loop, "d": release_check(window, graph)}


def release_check(window, graph) -> dict:
    """Phase 15 (d), the last work in the NCCL group of one: the windows
    ``multihost`` tracks hold 15a's live window (``graph``, held by
    ``window``); ``multihost.shutdown()`` releases every one of them before
    the group goes, with no release here, and the card's reserved memory
    falls by at least what 15a's window held."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    tracked = mh.live_windows()
    d = {"tracked_before": len(tracked),
         "holds_15a": any(w is graph for w in tracked)}
    del tracked, graph
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    mh.shutdown()
    torch.cuda.empty_cache()
    d.update(tracked_after=len(mh.live_windows()),
             group_left=not dist.is_initialized(),
             window_graphs_reset=all(g.graph is None
                                     for g in window.graphs.values()),
             freed_gib=(before - torch.cuda.memory_reserved()) / 2 ** 30)
    return d


def dp_window_gloo(setup, cap: int, ref_path: str) -> dict:
    """Phase 15 (b) and the gloo loop of (c), on this rank of two (gloo,
    sharing the card; ``setup``: ``rank_setup()``'s): a window of
    DP_WINDOW_B steps at ``cap`` on views (2s, 2s + 1) of ``poses()``, rank
    r taking view 2s + r, against ``ref_path`` (the group-of-one step on
    both rows, ``dp_window_reference``), then a second, warm window
    timed; then phase 14d's loop, cut to GLOO_LOOP_ITERS iterations, with
    ``data_parallel_devices: 2``."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    t0 = time.perf_counter()
    rank = mh.rank()
    dev, feats, camera, config, _, start, inputs = setup
    band = inputs[4]
    views = view_targets(start, feats, camera,
                         list(range(2 * DP_WINDOW_B)), {"tile_size": TILE})
    rows = window_rows(views, [[2 * s + rank] for s in range(DP_WINDOW_B)])
    window = make_dp_train_step(config, HEIGHT, WIDTH, device=dev,
                                scan_steps=DP_WINDOW_B, key_cap=cap)
    kernels = rank_kernels()
    torch.cuda.synchronize()
    dist.barrier()
    zero_launches(kernels)
    (new, wm, _), first_ms = synced_ms(window, start, *rows, band)
    launches = read_launches(kernels)
    ref = torch.load(ref_path, map_location=dev)
    leaves = state_leaves(new)
    b = {"mode": window.mode, "captures": window.captures,
         "graphs": len(window.graphs), "backend": dist.get_backend(),
         "digest": state_digest(new),
         "losses": [float(v) for v in wm["loss"]],
         "ref_losses": ref["losses"],
         "gate_excess": {k: gate_excess(leaves[k], ref[k])
                         for k in ("features", "xyz", "feat_mu", "pos_mu")},
         "num_in_camera_equal": bool(torch.equal(
             leaves["ctrl_num_in_camera"], ref["ctrl_num_in_camera"])),
         "first_call_ms_per_step": first_ms / DP_WINDOW_B,
         "launches": launches}
    del leaves, ref
    # a second window from where the first ended, warm: ms a step
    dist.barrier()
    _, ms = synced_ms(window, new, *rows, band)
    b["ms_per_step"] = ms / DP_WINDOW_B
    b["seconds"] = time.perf_counter() - t0
    del window, new
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    xyz, feats_l = truck_scene_surround(N_POINTS)
    views = loop_views(full_K_np(), dev)
    Trainer = loop_trainer_class(views[:6], views[6:], xyz, feats_l, [])
    log_dir = tempfile.TemporaryDirectory()
    trainer = Trainer(loop_config(
        log_dir.name, steps_per_dispatch=WINDOW, data_parallel_devices=2,
        num_iterations=GLOO_LOOP_ITERS), device=dev)
    windows = record_windows(trainer)
    state, loop_ms = synced_ms(trainer.train)
    log_dir.cleanup()
    return {"b": b, "loop": {
        "windows": windows, "digest": state_digest(state),
        "ms_per_iteration": loop_ms / GLOO_LOOP_ITERS,
        "finite": bool(torch.isfinite(state.scene.features).all()),
        "seconds": time.perf_counter() - t0}}


def dp_window_reference(xyz, feats, path: str) -> int:
    """Phase 15 (b)'s reference, in this process (no process group: a
    group of one): DP_WINDOW_B capped data-parallel steps on both rows of
    each step, at phase 14a's capacity (``eager_key_cap``), saved to
    ``path``. Returns the capacity."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )

    camera = full_camera(HEIGHT, WIDTH, "cuda")
    config, step, state, inputs = train_setup(xyz, feats, camera,
                                              {"tile_size": TILE})
    band = inputs[4]
    views = view_targets(state, feats, camera,
                         list(range(2 * DP_WINDOW_B)), {"tile_size": TILE})
    cap = eager_key_cap(step, state, views, band)
    rows = window_rows(views, [[2 * s, 2 * s + 1]
                               for s in range(DP_WINDOW_B)])
    dp = make_dp_train_step(config, HEIGHT, WIDTH, device="cuda",
                            key_cap=cap)
    losses = []
    for s in range(DP_WINDOW_B):
        state, m, _ = dp(state, *(x[s] for x in rows), band)
        losses.append(float(m["loss"]))
    leaves = state_leaves(state)
    torch.save({**{k: leaves[k] for k in ("features", "xyz", "feat_mu",
                                          "pos_mu", "ctrl_num_in_camera")},
                "losses": losses}, path)
    return cap


def check_dp_windows(res: dict, ref14: dict) -> dict:
    """Phase 15's record (``res``: what the ranks of phases 10-12 ran for
    it, ``run_multi_rank``), printed and held to its gates; ``ref14``:
    phase 14's record."""
    a, loop = res["nccl"]["a"], res["nccl"]["c"]
    cap14 = ref14["window_key_cap"]
    print(f"  (a) NCCL, one rank, {WINDOW} steps a window at key_cap "
          f"{a['cap']} (phase 14a: {cap14}): mode {a['mode']}, captures "
          f"{a['captures']}, graphs {a['graphs']}; bit for bit against phase"
          f" 14a's single-device window: window {a['window_equal']}, "
          f"replayed from the start {a['replay_equal']}, {WINDOW} eager "
          f"capped DP steps {a['eager_steps_equal']}; {a['ms_per_step']:.3f}"
          f" ms a step over warm replays (phase 14c: "
          f"{ref14['window_ms_per_step']:.3f}; the eager DP step, phase "
          f"10a's path: {a['eager_dp_step_ms']:.3f}), device "
          f"{a['device_ms_per_step']:.3f} ms a step, busy "
          f"{a['profile']['busy_share']:.3f}; capture {a['capture_s']:.3f} s,"
          f" first call {a['first_call_ms']:.1f} ms, pool {a['pool_gib']:.3f}"
          f" GiB (phase 14a: {ref14['window_pool_reserved_gib']:.3f}); "
          f"launches a window from the trace {a['launches']}, NCCL's kernels "
          f"{a['profile']['nccl_launches_per_window']}; collectives a step "
          f"{a['collectives']} [{a['seconds']:.1f} s in the rank]",
          flush=True)
    if a["backend"] != "nccl" or a["mode"] != "graph" or a[
            "captures"] != 1 or a["graphs"] != 1:
        raise AssertionError(f"15a: not one graph over NCCL: {a}")
    if a["cap"] != cap14 or res["gloo_cap"] != cap14:
        raise AssertionError(f"15: capacities {a['cap']}, "
                             f"{res['gloo_cap']} against phase 14a's {cap14}")
    if not (a["window_equal"] and a["replay_equal"]
            and a["eager_steps_equal"] and a["finite_frame"]):
        raise AssertionError("15a: the DP window differs from the "
                             "single-device window or its eager steps")
    for name, n in a["launches"].items():
        if n != WINDOW * len(WINDOW_SYMBOLS[name]):
            raise AssertionError(f"15a {name}: {n} launches in a window of "
                                 f"{WINDOW} steps")
    d = res["nccl"]["d"]
    wins = loop["window_loop_windows"]
    print(f"  (c) NCCL, one rank: {loop['window_loop_ms_per_iteration']:.2f}"
          f" ms an iteration over train() (phase 14d: "
          f"{ref14['window_loop_ms_per_iteration']:.2f}); windows "
          f"{len(wins)}, captures {sum(r['captured'] for r in wins)}, "
          f"refits {loop['window_loop_refits']}, resume equal "
          f"{loop['window_loop_resume_equal']} [{loop['seconds']:.1f} s in "
          f"the rank]", flush=True)
    keys = {(tuple(r["size"]), r["sh_band"], r["key_cap"]) for r in wins}
    if (len(wins) < 2 or any(r["graphs_held"] != 1 for r in wins)
            or sum(r["captured"] for r in wins) != len(keys)
            or not loop["window_loop_resume_equal"]):
        raise AssertionError(f"15c (NCCL): windows, captures or the resume:"
                             f" {loop}")
    print(f"  (d) NCCL, one rank, the release: windows tracked after 15a "
          f"and 15c {d['tracked_before']} (15a's among them "
          f"{d['holds_15a']}); after shutdown() {d['tracked_after']}, the "
          f"group left {d['group_left']}, 15a's graph reset "
          f"{d['window_graphs_reset']}; reserved memory fell by "
          f"{d['freed_gib']:.3f} GiB (15a's window held {a['held_gib']:.3f}"
          f" after empty_cache, its pool {a['pool_gib']:.3f})", flush=True)
    if not (d["holds_15a"] and d["tracked_after"] == 0 and d["group_left"]
            and d["window_graphs_reset"]
            and d["freed_gib"] >= a["held_gib"]):
        raise AssertionError(f"15d: shutdown() did not release the live "
                             f"windows: {d}")

    b = [r["b"] for r in res["gloo"]]
    gl = [r["loop"] for r in res["gloo"]]
    print(f"  (b) gloo, two ranks sharing the card, {DP_WINDOW_B} steps on "
          f"views (2s, 2s+1): modes {[x['mode'] for x in b]}, captures "
          f"{[x['captures'] for x in b]}; digests equal "
          f"{b[0]['digest'] == b[1]['digest']}; losses {b[0]['losses']} "
          f"(group of one on both rows {b[0]['ref_losses']}); gate excess "
          f"{b[0]['gate_excess']}; {[x['ms_per_step'] for x in b]} ms a step"
          f" warm (first call {[x['first_call_ms_per_step'] for x in b]}); "
          f"launches {[x['launches'] for x in b]} [{b[0]['seconds']:.1f} s "
          f"in the ranks]", flush=True)
    print(f"  (c) gloo, two ranks, {GLOO_LOOP_ITERS} iterations with "
          f"steps_per_dispatch {WINDOW}: windows {gl[0]['windows']}; "
          f"digests equal {gl[0]['digest'] == gl[1]['digest']}; "
          f"{[x['ms_per_iteration'] for x in gl]} ms an iteration "
          f"[{gl[0]['seconds']:.1f} s in the ranks]", flush=True)
    if any(x["backend"] != "gloo" or x["mode"] != "eager" or x["captures"]
           or x["graphs"] for x in b):
        raise AssertionError(f"15b: not eager over gloo: {b}")
    if b[0]["digest"] != b[1]["digest"]:
        raise AssertionError("15b: the ranks' states differ")
    if (not np.allclose(b[0]["losses"], b[0]["ref_losses"], rtol=1e-5,
                        atol=0)
            or max(b[0]["gate_excess"].values()) > 0
            or not b[0]["num_in_camera_equal"]):
        raise AssertionError("15b: outside the gates of the group of one")
    for x in b:
        if any(v != DP_WINDOW_B for v in x["launches"].values()):
            raise AssertionError(f"15b launches {x['launches']}")
    if (gl[0]["digest"] != gl[1]["digest"] or not gl[0]["finite"]
            or not gl[0]["windows"] or gl[0]["windows"] != gl[1]["windows"]):
        raise AssertionError(f"15c (gloo): {gl}")
    for x in b:
        x.pop("digest")
    return {"dp_window_nccl": a, "dp_window_nccl_loop": loop,
            "dp_window_nccl_release": d,
            "dp_window_gloo": b, "dp_window_gloo_loop": gl}


# --- phase 16: the synthetic quality gate --------------------------------------

# The JAX package's default preset on a TPU v5e: best val PSNR 27.07 and
# 27.222 (RESULTS.md:34-36, logs_quality_run_r1.txt; 27.188 in
# RESULTS.md:433-436), 40,000 final valid points, 1.3 it/s
# (logs_quality_run_r1.txt). The gate: 0.5 dB either side of that band.
JAX_QUALITY_PSNR = (27.07, 27.222)
JAX_QUALITY_POINTS = 40_000
JAX_TPU_IT_S = 1.3
QUALITY_PSNR_GATE = (26.57, 27.72)
QUALITY_MIN_POINTS = 36_000


def run_quality_gate(kernels, dev="cuda") -> dict:
    """Phase 16: ``tools/quality_run.py``'s default preset in full (2001
    iterations, 48 views at 256 px, windows of 10 steps) into a temporary
    directory: the best val PSNR against the JAX package's band, the final
    valid points, the val PSNR at each validation, the time, the windows,
    the refits and each kernel's launches, counted by the wrappers over the
    run (in its eager steps, validation frames and each graph's warm-up
    and capture; a replay does not tick them)."""
    from taichi_3d_gaussian_splatting_tpu_torch.tools import quality_run as qr
    from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
        from_dict,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        GaussianPointCloudTrainer,
    )

    out = tempfile.TemporaryDirectory()
    args = qr.parse_args(["--out", out.name, "--device", dev])
    t0 = time.perf_counter()
    data = qr.make_dataset(args)
    qr.write_dataset(args.out, data)
    data_s = time.perf_counter() - t0
    print(f"  dataset: {len(data.train)} train / {len(data.val)} val views "
          f"at {args.width}x{args.hw} (PNGs), {len(data.init_points)} init "
          f"points (.parquet), {data.gt_points} GT points (keys a view "
          f"{min(data.gt_keys)}-{max(data.gt_keys)}); {data_s:.1f} s",
          flush=True)
    trainer = GaussianPointCloudTrainer(from_dict(qr.config_dict(args)),
                                        device=dev)
    if dev == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    with plain_calls() as plain:
        rec = qr.train(trainer, args.iterations)
    launches = read_launches(kernels)
    state = rec.pop("state")
    phase_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_reserved() / 2 ** 30 if dev == "cuda"
            else float("nan"))
    scene_files = len(list(Path(args.out, "logs").glob("*.parquet")))
    eager_steps = (rec["steps_run"]
                   - trainer.config.steps_per_dispatch * rec["windows"])
    best, points = rec["best_val_psnr"], rec["final_valid_points"]
    print(f"  best val PSNR {best:.3f} (the JAX package on a TPU v5e: "
          f"{JAX_QUALITY_PSNR[0]}-{JAX_QUALITY_PSNR[1]}, RESULTS.md; gate "
          f"{list(QUALITY_PSNR_GATE)})", flush=True)
    print(f"  final valid points {points} (JAX: {JAX_QUALITY_POINTS}; gate "
          f">= {QUALITY_MIN_POINTS})", flush=True)
    print(f"  val PSNR by iteration {rec['val_psnr']}; valid points there "
          f"{rec['val_points']}", flush=True)
    print(f"  {rec['seconds']:.1f} s for {args.iterations} iterations of "
          f"train(), {rec['it_per_s']:.2f} it/s (the JAX package's run on a "
          f"TPU v5e: {JAX_TPU_IT_S} it/s, a TPU figure from "
          f"logs_quality_run_r1.txt and RESULTS.md); the phase "
          f"{phase_s:.1f} s with the dataset; peak reserved {peak:.3f} GiB",
          flush=True)
    print(f"  windows {rec['windows']}: {rec['captures']} graphs captured, "
          f"{rec['replays']} replays, graphs held after a window "
          f"{rec['graphs_held']}; eager steps {eager_steps}; refits "
          f"(before, after, live keys) {rec['refits']}; steps with keys "
          f"past key_cap {rec['steps_past_key_cap']}, non-finite losses "
          f"{rec['nonfinite_losses']}", flush=True)
    print(f"  launches (the wrappers' counters: eager steps, validation "
          f"frames, each graph's warm-up and capture; not the replays) "
          f"{launches}; plain versions {plain}; scene files (.parquet) "
          f"{scene_files}", flush=True)
    if not QUALITY_PSNR_GATE[0] <= best <= QUALITY_PSNR_GATE[1]:
        raise AssertionError(f"best val PSNR {best:.3f} outside "
                             f"{QUALITY_PSNR_GATE}")
    if points < QUALITY_MIN_POINTS:
        raise AssertionError(f"{points} final valid points, under "
                             f"{QUALITY_MIN_POINTS}")
    if any(plain.values()):
        raise AssertionError(f"the gate ran a plain version: {plain}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel was never launched: {launches}")
    if rec["nonfinite_losses"] or rec["steps_run"] != args.iterations:
        raise AssertionError(f"{rec['nonfinite_losses']} non-finite losses, "
                             f"{rec['steps_run']} steps run")
    if not rec["windows"] or rec["graphs_held"] != [1]:
        raise AssertionError(f"the gate ran {rec['windows']} windows, "
                             f"holding {rec['graphs_held']} graphs after one"
                             f" (one wanted)")
    if not bool(torch.isfinite(state.scene.features).all()):
        raise AssertionError("non-finite features after the gate")
    out.cleanup()
    return {**rec, "launches": launches, "plain_calls": plain,
            "eager_steps": eager_steps, "phase_s": phase_s,
            "dataset_s": data_s, "peak_reserved_gib": peak,
            "scene_files": scene_files,
            "jax_tpu": {"best_val_psnr": list(JAX_QUALITY_PSNR),
                        "final_valid_points": JAX_QUALITY_POINTS,
                        "it_per_s": JAX_TPU_IT_S},
            "gate": {"best_val_psnr": list(QUALITY_PSNR_GATE),
                     "min_final_valid_points": QUALITY_MIN_POINTS}}


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

    from kernel_variants import keys_step0

    dev = torch.device("cuda")
    R.pin_f32_matmul()
    card = card_line()
    t0 = time.perf_counter()
    first_dir = tempfile.TemporaryDirectory()
    first_build = threading.Thread(target=keys_step0.build_v1,
                                   args=(Path(first_dir.name),))
    first_build.start()  # its two nvcc run beside the package's five
    build_s = cuda_build.build_all()
    first_build.join()
    first = keys_step0.FirstDesign(Path(first_dir.name))
    print(f"built {sorted(build_s)} and the first design's K1, K5 in "
          f"{time.perf_counter() - t0:.2f} s (nvcc in parallel: {build_s})",
          flush=True)
    # every kernel of the main path, by its launch counter; K1 is two
    render_kernels = {"slot_keys": expand.slot_keys,
                      "sorted_table": expand.sorted_table,
                      "tile_ranges": histogram.tile_ranges,
                      "blend_forward": blend.blend_forward}
    kernels = dict(render_kernels, blend_backward=blend.blend_backward,
                   segment_reduce_sorted=sr.segment_reduce_sorted)
    counters_of = {"expand_keys": ("slot_keys", "sorted_table"),
                   "tile_ranges": ("tile_ranges",),
                   "blend_forward": ("blend_forward",),
                   "blend_backward": ("blend_backward",),
                   "segment_reduce": ("segment_reduce_sorted",)}

    # phase 1a: the small frame
    q_id = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t_id = torch.zeros(3, device=dev)
    small = small_frame(dev)
    t_run = time.perf_counter()

    def phase(title):
        print(f"{title} [{time.perf_counter() - t_run:.1f} s]", flush=True)

    phase("phase 1: kernels against their plain versions")
    check_kernels(small, "64x64", full_width=False, first=first)
    phase("phase 1b: backward kernels against their plain versions")
    check_backward_kernels(small, "64x64", full_width=False, first=first)

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
    errs = check_kernels(full, f"{WIDTH}x{HEIGHT}", full_width=True,
                         first=first)
    bwd_errs, k4_plain_ms, bwd = check_backward_kernels(
        full, f"{WIDTH}x{HEIGHT}", full_width=True, first=first)
    errs.update(bwd_errs)

    # phase 2: the main path, with the launch counts read around it
    phase("phase 2: render through GaussianPointRenderer")
    zero_launches(kernels)
    expand.slot_keys.capped_launches = 0
    histogram.tile_counts.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with first_design_calls() as off_path:
        frames = dict(renderer.frames())
    first_pass_s = time.perf_counter() - t0
    launches = read_launches(render_kernels)
    if histogram.tile_counts.launches:  # render graphs record no counters
        raise AssertionError(f"the render path launched tile_counts "
                             f"{histogram.tile_counts.launches} times")
    graph = graph_frames(renderer, launches, expand.slot_keys.capped_launches)
    print(f"  {len(frames)} frames in {first_pass_s:.3f} s (first pass, the "
          f"capture included); launches {launches} (the graph's warm-up and "
          f"capture); first design's calls {off_path}", flush=True)
    if any(off_path.values()):
        raise AssertionError(f"the render path ran the first design's data "
                             f"movement: {off_path}")
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

    def exact_frame():
        i = state["i"] % n_poses
        state["i"] += 1
        out = R.rasterize(s.xyz, s.features, s.invalid, qs[i], ts[i],
                          renderer.camera, renderer.rcfg, sh_max_band=3,
                          point_object_id=s.object_id)
        torch.clamp(out.rgb, 0.0, 1.0)

    torch.cuda.reset_peak_memory_stats()
    frame_ms = cuda_ms(one_frame, reps=45, warmup=9)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    exact_ms = cuda_ms(exact_frame, reps=45, warmup=9)
    print(f"  the graph frame (key_cap {renderer.key_cap}) {frame_ms:.4f} ms,"
          f" the exact eager frame {exact_ms:.4f} ms; "
          f"{card}", flush=True)
    t0 = time.perf_counter()
    frames = dict(renderer.frames())
    frames_s = time.perf_counter() - t0
    mpix_s = HEIGHT * WIDTH / 1e6 / (frame_ms / 1e3)
    stages = stage_ms(renderer, q_id, t_id)
    busy = device_busy(one_frame, reps=18,
                       expect=("blend_forward_kernel(",))
    for name, v in stages.items():
        print(f"  stage {name}: wall {v['wall_ms']:.4f} ms, device "
              f"{v['device_ms']:.4f} ms", flush=True)
    print(f"  profiler: {busy}", flush=True)

    k = full.keys
    rgb_table = full.table
    att = full.expand_args[5]
    _, owner = expand.slot_keys(*full.expand_args, **full.expand_kw)
    fused_s, perm = k.fused, k.orig_slot
    rows_k5, inv = bwd["rows"], bwd["inv"]
    bwd_args = bwd["bwd_args"]
    # per TPU kernel: its launches (wrapper call, kernel symbol) and its
    # plain version (None: timed in phase 1b)
    timed = {
        "expand_keys": (
            [(lambda: expand.slot_keys(*full.expand_args, **full.expand_kw),
              "slot_keys_kernel"),
             (lambda: expand.sorted_table(fused_s, perm, owner, att,
                                          **full.table_kw),
              "sorted_table_kernel")],
            lambda: (expand.slot_keys_plain(*full.expand_args,
                                            **full.expand_kw),
                     expand.sorted_table_plain(fused_s, perm, owner, att,
                                               **full.table_kw))),
        "tile_ranges": (
            [(lambda: histogram.tile_ranges(fused_s, full.dbits,
                                            full.num_tiles),
              "tile_ranges_kernel")],
            lambda: histogram.tile_ranges_plain(fused_s, full.dbits,
                                                full.num_tiles)),
        "blend_forward": (
            [(lambda: blend.blend_forward(rgb_table, k.tile_start,
                                          k.tile_end, rgb_only=True,
                                          **full.blend_kw),
              "blend_forward_kernel")],
            lambda: blend.blend_forward_plain(rgb_table, k.tile_start,
                                              k.tile_end, rgb_only=True,
                                              **full.blend_kw)),
        "blend_backward": (
            [(lambda: blend.blend_backward(*bwd_args, **full.blend_kw),
              "blend_backward_kernel")], None),
        "segment_reduce": (
            [(lambda: sr.segment_reduce_sorted(rows_k5, inv, k.offsets,
                                               k.counts),
              "segment_reduce_kernel")],
            lambda: sr.segment_reduce_sorted_plain(rows_k5, inv, k.offsets,
                                                   k.counts)),
    }
    # "ms" is the kernel's own device time per launch, summed over its
    # launches (K1: K1a + K1b); "plain_ms" and "library_ms" are device time
    # per call (blend_backward's plain_ms: the wall time of its one call);
    # a call's wall time (host included) is kept beside them in the record
    ms = {n: sum(kernel_ms(fn, sym, reps=50) for fn, sym in parts)
          for n, (parts, _) in timed.items()}
    # the blend wrappers also launch the tile-order kernel (heaviest tile
    # first, csrc/tile_order.cuh) before the blend: its own time a call
    order_ms = {n: kernel_ms(timed[n][0][0][0], "tile_order_kernel", reps=50)
                for n in ("blend_forward", "blend_backward")}
    call_ms = {n: sum(cuda_ms(fn, reps=50, warmup=5) for fn, _ in parts)
               for n, (parts, _) in timed.items()}
    # the plain blend and segment sum launch a few kernels a key position
    plain_ms = {n: device_ms(p, reps=2 if n in ("blend_forward",
                                                "segment_reduce") else 10,
                             expect=("searchsorted",) if n == "tile_ranges"
                             else EW)
                for n, (_, p) in timed.items() if p is not None}
    plain_ms["blend_backward"] = k4_plain_ms  # its one call in phase 1b
    queries = torch.arange(full.num_tiles + 1, dtype=torch.int32,
                           device=dev)
    searchsorted_ms = device_ms(lambda: torch.searchsorted(
        full.tile_ids, queries, out_int32=True), reps=50,
        expect=("searchsorted",))
    print(f"  K2: tile_ranges {ms['tile_ranges']:.5f} ms (device), "
          f"{call_ms['tile_ranges']:.5f} ms (events); torch.searchsorted "
          f"{searchsorted_ms:.5f} ms", flush=True)
    lengths = k.counts.long()

    def segment_reduce_library():
        # the library chain for K5's function: the regroup to pre-sort
        # order (index_copy_), then torch.segment_reduce over the points'
        # contiguous segments (lengths = counts, offsets their cumsum)
        d_orig = torch.empty_like(rows_k5).index_copy_(1, perm, rows_k5)
        return torch.segment_reduce(d_orig.T.contiguous(), "sum",
                                    lengths=lengths, axis=0, unsafe=True)
    segment_reduce_lib_ms = device_ms(segment_reduce_library, reps=50,
                                      expect=("index_copy", "segment_reduce"))
    library_ms = {"tile_ranges": searchsorted_ms,
                  "segment_reduce": segment_reduce_lib_ms}
    # the first design's stages around K1 and K5 (this design's are in
    # the render and train stage tables)
    design_ms = keys_step0.first_design_stages(first, full, rows_k5)
    for name, v in design_ms.items():
        print(f"  first design's stage {name}: {v}", flush=True)

    # phase 4: the training step, with the launch counts read around its
    # timed steps
    phase("phase 4: train steps at full width")
    train = run_training(xyz, feats, renderer.camera, {"tile_size": TILE},
                         kernels)

    # phase 5: the training loop, with the launch counts read around it
    phase("phase 5: the training loop at full width")
    loop, loop_scene = run_loop(xyz, feats, K_np, train["train_ms_per_step"],
                                kernels)

    # phases 6-9: the launch counts set to 0 just before each path and read
    # just after it
    phase("phase 6: pose-refining train steps at full width")
    pose = run_pose_training(xyz, feats, K_np, train["train_ms_per_step"],
                             kernels)
    work_dir = tempfile.TemporaryDirectory()
    phase("phase 7: the viewer answers requests")
    viewer = run_viewer(xyz, feats, kernels, Path(work_dir.name))
    phase("phase 8: render from a dataset .json (rgb_only, pack_sort_colors)")
    dataset = run_dataset_render(xyz, feats, K_np, kernels,
                                 Path(work_dir.name))
    phase("phase 9: ft_grab_scene on the loop's final scene")
    ftgmm = run_ftgmm(loop_scene, Path(work_dir.name))
    # phases 10-13: ranks in processes of their own, each counting its
    # launches around each path
    multi = run_multi_rank(xyz, feats, frames, Path(work_dir.name), phase,
                           loop["loop_ms_per_iteration"])
    work_dir.cleanup()
    # phase 14: windows of steps, each one CUDA graph replay; the launches
    # come from the profiler's trace of replays
    phase("phase 14: windowed training at full width (one CUDA graph a "
          "window)")
    windowed = run_windowed(xyz, feats, renderer.camera, {"tile_size": TILE},
                            {"step_ms": train["train_ms_per_step"],
                             "device_ms": train["train_device_ms_per_step"]})
    windowed.update(run_window_loop(xyz, feats, K_np,
                                    loop["loop_ms_per_iteration"]))
    windowed.update(run_window_reuse(xyz, feats, K_np))
    # phase 15: windows of data-parallel steps, run by the ranks of phases
    # 10-12 (a graph in the NCCL group of one, eager over gloo); each rank
    # counts its own launches (gloo) or reads them from its trace of
    # replays (NCCL)
    phase("phase 15: data-parallel windows at full width (one CUDA graph a "
          "window in an NCCL group of one, eager over gloo; the release at "
          "the group's end)")
    dpw = check_dp_windows(multi.pop("dp_windows"), windowed)
    # phase 16: the quality gate's default preset in full, with the launch
    # counts set to 0 just before its train() and read just after
    phase("phase 16: the synthetic quality gate (tools/quality_run.py, "
          "default preset: 2001 iterations, 48 views at 256 px, windows of "
          "10)")
    quality = run_quality_gate(kernels)
    # phase 17: the inference benchmark's reference protocol, with the
    # launch counts set to 0 just before it and read just after
    phase("phase 17: the inference benchmark (tools/inference_benchmark.py,"
          " 1000 warm-up and 100 timed frames, one CUDA graph a bucket)")
    with tempfile.TemporaryDirectory() as tmp17:
        infer = run_inference_benchmark(xyz, feats, K_np, kernels,
                                        Path(tmp17), card)

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
    n_rows = rows_k5.shape[0]
    work = {
        # reads offsets, dkey, base, h (4 x 4 B) and 10 attr rows per point;
        # writes the fused key and 16 table rows per key (K1a's owners and
        # K1b's reads of them and of perm are the design's, not the
        # function's). Per key: a binary search (2 ops a step) and the cull
        # (~45 flops)
        "expand_keys": (4 * 4 * n + 10 * 4 * n + 17 * 4 * total,
                        total * (2 * math.ceil(math.log2(n)) + 45)),
        # reads every sorted key, writes the num_tiles + 1 bounds; one
        # comparison per key
        "tile_ranges": (4 * total + 4 * (full.num_tiles + 1), total),
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
        # reads every row lane and the inverse permutation once and the
        # offsets and counts, writes one float a (row, point); one add per
        # row lane
        "segment_reduce": (4 * n_rows * total + 4 * total + 8 * n
                           + 4 * n_rows * n, n_rows * total),
    }
    source = "taichi_3d_gaussian_splatting_tpu_torch/csrc/{}.cu"
    replaces = {
        "expand_keys": "taichi_3d_gaussian_splatting_tpu/ops/expand.py:318",
        "tile_ranges":
            "taichi_3d_gaussian_splatting_tpu/ops/histogram.py:78",
        "blend_forward":
            "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:389",
        "blend_backward":
            "taichi_3d_gaussian_splatting_tpu/ops/blend_pallas.py:748",
        "segment_reduce":
            "taichi_3d_gaussian_splatting_tpu/ops/segment_reduce.py:235",
    }
    src = {"expand_keys": "expand", "tile_ranges": "histogram",
           "blend_forward": "blend", "blend_backward": "blend_backward",
           "segment_reduce": "segment_reduce"}
    rows = []
    for name, counters in counters_of.items():
        nbytes, ops = work[name]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source.format(src[name]),
            "replaces": replaces[name],
            "launches": sum(loop["loop_launches"][c] for c in counters),
            "launches_train_steps": sum(train["train_launches"][c]
                                        for c in counters),
            "launches_per_step": sum(train["train_launches_per_step"][c]
                                     for c in counters),
            "launches_per_frame": graph["render_launches_per_replay"].get(
                name, 0),
            "launches_render_graph_capture": sum(launches.get(c, 0)
                                                 for c in counters),
            "launches_pose_steps": sum(pose["pose_launches"][c]
                                       for c in counters),
            "launches_viewer_frames": sum(viewer["viewer_launches"][c]
                                          for c in counters),
            "launches_dataset_frames": sum(dataset["dataset_launches"][c]
                                           for c in counters),
            # phases 10-13, per rank: a DP step (a group of one over NCCL;
            # two ranks over gloo), a band-parallel step at 1920x1088, the
            # render app's 9 frames pose-sharded and band-split, mh_smoke's
            # 2 steps of 4 cameras a rank
            "launches_dp_step_world1": sum(
                multi["dp_world1"]["launches"][c] for c in counters),
            "launches_dp_step_per_rank": [
                sum(r["launches_per_step"][c] for c in counters)
                for r in multi["dp_two_ranks"]["two_views"]],
            "launches_tp_step_per_rank": [
                sum(r["launches_per_step"][c] for c in counters)
                for r in multi["tp"]],
            "launches_render_dp_per_rank": [
                sum(r["data_parallel"]["launches"].get(c, 0)
                    for c in counters) for r in multi["render"]],
            "launches_render_tp_per_rank": [
                sum(r["tile_parallel"]["launches"].get(c, 0)
                    for c in counters) for r in multi["render"]],
            "launches_mh_smoke_per_rank": [
                sum(r[c] for c in counters)
                for r in multi["mh_smoke"]["launches"]],
            # phase 14: a window of WINDOW steps, counted from the
            # profiler's trace of its replays
            "launches_window_replay": windowed["window_launches"][name],
            # phase 15, per rank: a DP window of WINDOW steps in a group of
            # one over NCCL (from the trace of its replays) and of
            # DP_WINDOW_B steps on two gloo ranks (the counters)
            "launches_dp_window_world1": dpw["dp_window_nccl"]["launches"][
                name],
            "launches_dp_window_per_rank": [
                sum(x["launches"][c] for c in counters)
                for x in dpw["dp_window_gloo"]],
            "ms_window_replay": windowed["window_profile"][
                "kernel_ms_under_replay"][name],
            # phase 16: the wrappers' counters over the gate's train()
            # (eager steps, validation frames, graph warm-ups and captures)
            "launches_quality_run": sum(quality["launches"][c]
                                        for c in counters),
            # phase 17: the wrappers' counters over the benchmark's 1100
            # frames (its graph's warm-up and capture), and a replay's
            # launches from the trace
            "launches_inference_benchmark": sum(infer["launches"][c]
                                                for c in counters),
            "launches_inference_replay": infer["launches_per_replay"].get(
                name, 0),
            "kernel_symbols": [sym for _, sym in timed[name][0]],
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
        "launches_per_frame": graph["render_launches_per_replay"], **graph,
        "render_exact_ms_per_frame": exact_ms,
        "searchsorted_ms": searchsorted_ms,
        "segment_reduce_library_ms": segment_reduce_lib_ms,
        "kernel_call_wall_ms": call_ms, "first_design_stage_ms": design_ms,
        "render_first_design_calls": off_path,
        "render_peak_mem_gib": peak_gib,
        "stage_ms": stages, "profile": busy,
        **train, **loop, **pose, **viewer, **dataset, **ftgmm, **windowed,
        **dpw,
        "multi_rank": multi, "quality_run": quality,
        "inference_benchmark": infer,
        "count_check": COUNT_CHECK, "profiler_windows": dict(WINDOWS),
        "kernels": rows,
    }
    print(f"render: {frame_ms:.3f} ms/frame, {mpix_s:.1f} Mpix/s; "
          f"{len(frames)} frames to host in {frames_s:.3f} s", flush=True)
    phase("done")
    print(f"train: {train['train_ms_per_step']:.3f} ms/step, "
          f"{train['train_mpix_s']:.1f} Mpix/s, peak "
          f"{train['train_peak_mem_gib']:.2f} GiB; loop: "
          f"{loop['loop_ms_per_iteration']:.2f} ms an iteration (whole "
          f"window), {loop['loop_iteration_ms']} ms a plain one by size; "
          f"pose-refining step {pose['pose_ms_per_step']:.3f} ms; viewer "
          f"frame {viewer['viewer_frame_ms_median']:.2f} ms (median); "
          f"ftgmm {ftgmm['ftgmm_ms']:.1f} ms; two ranks sharing the card: "
          f"DP step {[r['ms_per_step'] for r in multi['dp_two_ranks']['two_views']]}"
          f" ms, band-parallel step at 1920x1088 "
          f"{[r['ms_per_step'] for r in multi['tp']]} ms; windowed step "
          f"{windowed['window_ms_per_step']:.3f} ms ({WINDOW} steps a graph "
          f"replay), the loop with windows "
          f"{windowed['window_loop_ms_per_iteration']:.2f} ms an iteration; "
          f"DP window over NCCL (one rank) "
          f"{dpw['dp_window_nccl']['ms_per_step']:.3f} ms a step, its loop "
          f"{dpw['dp_window_nccl_loop']['window_loop_ms_per_iteration']:.2f}"
          f" ms an iteration; quality gate: best val PSNR "
          f"{quality['best_val_psnr']:.3f}, {quality['final_valid_points']} "
          f"points, {quality['it_per_s']:.2f} it/s; inference benchmark "
          f"{infer['ms']:.3f} ms a frame, {infer['fps']:.2f} FPS, "
          f"{infer['mpix_s']:.2f} Mpix/s", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({k_: record[k_] for k_ in record if k_ != "kernels"}))
    print(json.dumps({"kernels": rows}))
    print(card)
    first_dir.cleanup()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
