"""Standalone inference benchmark over a trained scene.

Port of ``benchmark/inference_benchmark.py`` (warm-up, then timed frames
over a dataset's cameras, ended by a device sync; a ``.parquet`` or
graphdeco ``.ply`` scene), flag for flag, plus ``--device``:

    python -m taichi_3d_gaussian_splatting_tpu_torch.tools.inference_benchmark \\
        --scene scene.ply --dataset val.json [--warmup 1000 --iters 100] \\
        [--save_image frame.png] [--device cuda]

As the JAX script: the items are decoded once up front; the static key
capacity is fitted to the key totals of every ``len // 8``-th item
(``fit_key_cap`` with headroom 1.1; each total read to the host, before
any frame); one render per (H, W) bucket, with the item's intrinsics
copied in (the JAX script's ``cam._replace(K=K)``). On a card that render
is one CUDA graph (``apps.render.FrameGraph``), the counterpart of the JAX
script's one ``jax.jit`` a bucket; on the CPU the same capped frame runs
eagerly. The items' poses and intrinsics are staged on the device with the
decode, so a frame copies them device to device.

``--key_cap`` is the JAX script's probe capacity, which there steers only
the TPU kernels' candidate mode; here it is accepted and unused (the probe
reads each exact total). ``--device`` is ``cuda`` unless the caller asks
for ``cpu`` (the kernels' plain versions): with no card the run fails, it
never falls back to the CPU.

Prints the JAX script's lines (``Inference time``, ``FPS``, ``Mpix/s``,
host clock over the timed frames) after the key capacity, the graphs
captured, the frames whose keys passed the capacity (their surplus keys
are dropped, as in JAX) and the timed frames' ms by CUDA events.
"""
from __future__ import annotations

import argparse
import itertools
import time

import numpy as np
import torch

from taichi_3d_gaussian_splatting_tpu_torch.apps.render import (
    FrameGraph,
    load_scene,
)
from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
    ImagePoseDataset,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
    Camera,
    RasterizerConfig,
    key_total,
    pin_f32_matmul,
    rasterize,
)
from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
    fit_key_cap,
)

HEADROOM = 1.1  # the JAX script's (the render app's is 1.15)


def check_device(device: str) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("inference_benchmark: no CUDA card "
                         "(torch.cuda.is_available() is False); --device cpu "
                         "runs the plain versions")
    return dev


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--scene", type=str, required=True,
                        help=".parquet or graphdeco .ply checkpoint")
    parser.add_argument("--dataset", type=str, required=True,
                        help="dataset .json providing cameras")
    parser.add_argument("--warmup", type=int, default=1000)
    parser.add_argument("--iters", type=int, default=100)
    parser.add_argument("--tile_size", type=int, default=32)
    parser.add_argument("--key_cap", type=int, default=2**21,
                        help="the JAX script's probe capacity (unused)")
    parser.add_argument("--save_image", type=str, default="")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain "
                        "versions)")
    return parser.parse_args(argv)


class Bench:
    """The scene, the decoded items staged on the device, the fitted
    capacity and one render a (H, W) bucket."""

    def __init__(self, args, dev: torch.device):
        self.dev = dev
        self.scene = load_scene(args.scene, dev)
        print(f"{self.scene.capacity} points")
        dataset = ImagePoseDataset(args.dataset, tile_size=args.tile_size)
        self.rcfg = RasterizerConfig(
            near_plane=0.8, far_plane=1000.0, depth_to_sort_key_scale=100.0,
            tile_size=args.tile_size, key_cap=args.key_cap, rgb_only=True,
            extra_info=False)
        # decode every item once (bench the renderer, not PIL)
        self.items = []
        for i in range(len(dataset)):
            it = dataset[i]
            info = it.camera_info
            put = lambda a: torch.as_tensor(  # noqa: E731
                np.asarray(a, np.float32), device=dev)
            self.items.append(((info.camera_height, info.camera_width),
                               put(it.q_pointcloud_camera),
                               put(it.t_pointcloud_camera),
                               put(info.camera_intrinsics)))
        s = self.scene
        worst = 0
        for hw, q, t, K in self.items[::max(1, len(self.items) // 8)]:
            cam = Camera(K=K, width=hw[1], height=hw[0])
            worst = max(worst, key_total(s.xyz, s.features, s.invalid, q, t,
                                         cam, self.rcfg,
                                         point_object_id=s.object_id))
        self.worst = worst
        self.key_cap = fit_key_cap(worst, headroom=HEADROOM)
        print(f"key_cap {self.key_cap} (worst probed key total {worst})")
        self.over_cap = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs = {}

    def frame(self, hw):
        """The capped frame of bucket ``hw``: (q, t, K) -> ((H, W, 3) rgb,
        () int64 1 if the keys passed the capacity)."""
        s, cap = self.scene, self.key_cap

        def render(q, t, K):
            out, total = rasterize(
                s.xyz, s.features, s.invalid, q, t,
                Camera(K=K, width=hw[1], height=hw[0]), self.rcfg,
                sh_max_band=3, point_object_id=s.object_id,
                return_num_keys=True, key_cap=cap)
            return out.rgb, (total > cap).to(torch.int64)
        return render

    def render(self, index: int) -> torch.Tensor:
        hw, q, t, K = self.items[index]
        if self.dev.type != "cuda":
            rgb, over = self.frame(hw)(q, t, K)
        else:
            if hw not in self.graphs:
                self.graphs[hw] = FrameGraph(self.frame(hw), (q, t, K),
                                             self.dev)
            rgb, over = self.graphs[hw](q, t, K)
        self.over_cap += over
        return rgb

    def release(self) -> None:
        for g in self.graphs.values():
            g.release()
        self.graphs = {}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> tuple:
    """The benchmark: (record, the ``Bench`` with its graphs still held).
    The record: key_cap, graphs, frames past the capacity, ms by host
    clock and by CUDA events, FPS, Mpix/s."""
    dev = check_device(args.device)
    pin_f32_matmul()
    bench = Bench(args, dev)
    stream = itertools.cycle(range(len(bench.items)))

    print("Warming up...")
    out = None
    for _ in range(args.warmup):
        out = bench.render(next(stream))
    sync(dev)

    print("Benchmarking...")
    events = None
    if dev.type == "cuda":
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = bench.render(next(stream))
    if events is not None:
        events[1].record()
    sync(dev)
    ms = (time.perf_counter() - t0) / args.iters * 1e3
    event_ms = (events[0].elapsed_time(events[1]) / args.iters
                if events is not None else None)
    h, w, _ = out.shape
    over = int(bench.over_cap)
    print(f"graphs captured: {len(bench.graphs)} (one a resolution bucket: "
          f"{sorted(bench.graphs)})")
    print(f"frames past the key capacity: {over} of "
          f"{args.warmup + args.iters}")
    if event_ms is not None:
        print(f"CUDA events: {event_ms:.4f} ms a frame (host clock "
              f"{ms:.4f} ms)")
    print(f"Inference time: {ms:.3f} ms")
    print(f"FPS: {1000.0 / ms:.2f}")
    print(f"Mpix/s: {h * w / 1e6 / (ms / 1e3):.2f}")

    if args.save_image:
        from PIL import Image

        rgb = np.clip(out.cpu().numpy(), 0, 1)
        Image.fromarray((rgb * 255).astype(np.uint8)).save(args.save_image)
    record = {"points": bench.scene.capacity, "key_cap": bench.key_cap,
              "worst_key_total": bench.worst,
              "graphs": sorted(bench.graphs), "frames_over_cap": over,
              "warmup": args.warmup, "iters": args.iters, "ms": ms,
              "event_ms": event_ms, "fps": 1000.0 / ms,
              "mpix_s": h * w / 1e6 / (ms / 1e3), "image": [w, h]}
    return record, bench


def main(argv=None) -> dict:
    """``run`` on the command line's flags; returns the record."""
    record, bench = run(parse_args(argv))
    bench.release()
    return record


if __name__ == "__main__":
    main()
