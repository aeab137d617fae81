"""Trace the rasterizer with ``torch.profiler`` and attribute device time.

Port of ``benchmark/profile_attribution.py``: the same seeded scene
(``default_rng(7)``, 1024x544, focal 1000 px, identity pose) and flags,
plus ``--device``. The JAX script sums device time by source line; here
device time (kernels, copies, sets) is summed a run by kernel name, and
by the stage of ``rasterize`` that launched it: the innermost
``ops.stages.stage`` range (a ``record_function`` range) named ``gs.*``
around the launch (``gs.attributes``, ``gs.tiling``, ``gs.blend``,
``gs.assemble``, ``gs.blend_backward``; a launch outside them, such as the
autograd of the attributes, counts as ``(unmarked)``). The train step's
stages (``gs.loss``, ``gs.attributes_vjp``, ``gs.update``,
``gs.state_copy``) and the replay calls' (``gs.replay``, ``gs.to_frame``)
do not run here; under graph replay the stages are read by
``ops.stages.read()``.

    python -m taichi_3d_gaussian_splatting_tpu_torch.tools.profile_attribution \\
        [--points 428000] [--runs 3] [--grad | --rgb-only] [--fit-cap] \\
        [--out DIR] [--device cuda]
    python -m taichi_3d_gaussian_splatting_tpu_torch.tools.profile_attribution \\
        --analyze-only DIR

As in JAX the frame runs at the static key capacity 2**21, or with
``--fit-cap`` at ``fit_key_cap(total, headroom=1.1)`` of the frame's key
total; one call runs before the traced ones. The trace is written as
``DIR/rasterize.trace.json`` (chrome format); ``--out`` defaults to
``gs_trace`` under the temporary directory (``TMPDIR``, else ``/tmp``).
``--device`` is ``cuda`` unless the caller asks for ``cpu``: a CPU trace
holds no device time.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import tempfile

TRACE_NAME = "rasterize.trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNMARKED = "(unmarked)"


def _load_trace(path: str) -> dict:
    """A chrome trace: the file itself, or the newest ``*.json[.gz]`` in a
    directory."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "*.json"))
                       + glob.glob(os.path.join(path, "*.json.gz")),
                       key=os.path.getmtime)
        assert found, f"no trace under {path}"
        path = found[-1]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _stage_of(launch, ranges) -> str:
    """The innermost ``gs.*`` range of the launch's thread around its
    start."""
    if launch is None:
        return UNMARKED
    best = None
    for r in ranges.get((launch["pid"], launch["tid"]), ()):
        if r["ts"] <= launch["ts"] <= r["ts"] + r["dur"] and (
                best is None or r["dur"] < best["dur"]):
            best = r
    return UNMARKED if best is None else best["name"]


def analyze(trace_path: str, runs: int, top: int = 25) -> dict:
    """Device ms a run in a chrome trace: in all, by stage, by kernel name
    (names cut to 90 characters). A device event is matched to the host
    launch of the same ``correlation`` id, and that launch to the ``gs.*``
    ``user_annotation`` ranges of its thread. Prints the sums; returns
    ``{"device_ms_per_run", "by_stage", "by_kernel"}``, each ms a run, the
    kernels the ``top`` longest."""
    events = [e for e in _load_trace(trace_path)["traceEvents"]
              if e.get("ph") == "X"]
    ranges = collections.defaultdict(list)
    launches = {}
    for e in events:
        cat = e.get("cat", "")
        if cat == "user_annotation" and e["name"].startswith("gs."):
            ranges[(e["pid"], e["tid"])].append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    by_stage = collections.Counter()
    by_kernel = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ms = float(e.get("dur", 0.0)) / 1e3 / runs
        launch = launches.get(e.get("args", {}).get("correlation"))
        by_stage[_stage_of(launch, ranges)] += ms
        by_kernel[e["name"][:90]] += ms
        total += ms
    print(f"\ndevice total: {total:.4f} ms/run")
    print("by stage (ms/run):")
    for name, ms in by_stage.most_common():
        print(f"  {ms:9.4f}  {name}")
    print("by kernel (ms/run):")
    for name, ms in by_kernel.most_common(top):
        print(f"  {ms:9.4f}  {name}")
    return {"device_ms_per_run": total, "by_stage": dict(by_stage),
            "by_kernel": dict(by_kernel.most_common(top))}


def seeded_scene(n_points: int):
    """The JAX script's scene, numpy arrays: (xyz, features)."""
    import numpy as np

    rng = np.random.default_rng(7)
    xyz = np.stack(
        [rng.uniform(-4, 4, n_points), rng.uniform(-4, 4, n_points),
         rng.uniform(2, 20, n_points)], -1).astype(np.float32)
    feats = np.zeros((n_points, 56), np.float32)
    q = rng.normal(size=(n_points, 4)).astype(np.float32)
    feats[:, 0:4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    feats[:, 4:7] = rng.uniform(-4.5, -2.5, (n_points, 3))
    feats[:, 7] = rng.uniform(-1, 3, n_points)
    feats[:, 8:] = rng.normal(size=(n_points, 48)) * 0.3
    return xyz, feats


def capture(trace_dir: str, n_points: int, runs: int, grad: bool = False,
            rgb_only: bool = False, fit_cap: bool = False,
            device: str = "cuda") -> dict:
    """Trace ``runs`` calls of the rasterizer (forward, or with ``grad``
    the gradient of the rgb sum with respect to xyz and features) after
    one untraced call; returns {"key_cap", "key_total", "trace"}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from taichi_3d_gaussian_splatting_tpu_torch.ops.rasterizer import (
        Camera, RasterizerConfig, key_total, pin_f32_matmul, rasterize,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training.trainer import (
        fit_key_cap,
    )

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_attribution: no CUDA card "
                         "(torch.cuda.is_available() is False); --device cpu "
                         "traces the plain versions")
    pin_f32_matmul()
    w, h = 1024, 544
    xyz_np, feats_np = seeded_scene(n_points)
    xyz = torch.as_tensor(xyz_np, device=dev)
    feats = torch.as_tensor(feats_np, device=dev)
    invalid = torch.zeros(n_points, dtype=torch.bool, device=dev)
    Q = torch.tensor([0.0, 0, 0, 1], device=dev)
    T = torch.zeros(3, device=dev)
    cam = Camera(K=torch.tensor([[1000.0, 0, w / 2], [0, 1000.0, h / 2],
                                 [0, 0, 1]], device=dev), width=w, height=h)
    cfg = RasterizerConfig(tile_size=32, extra_info=False, rgb_only=rgb_only)
    total = key_total(xyz, feats, invalid, Q, T, cam, cfg)
    cap = 2 ** 21
    if fit_cap:
        cap = fit_key_cap(total, headroom=1.1)
        print(f"fitted key_cap={cap} (total={total})")

    def run():
        if grad:
            x = xyz.detach().requires_grad_(True)
            f = feats.detach().requires_grad_(True)
            rgb = rasterize(x, f, invalid, Q, T, cam, cfg, key_cap=cap).rgb
            return torch.autograd.grad(rgb.sum(), (x, f))[0]
        return rasterize(xyz, feats, invalid, Q, T, cam, cfg,
                         key_cap=cap).rgb

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run()
    sync()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(runs):
            run()
        sync()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    return {"key_cap": cap, "key_total": total, "trace": path}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--points", type=int, default=428_000)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--out", type=str,
                        default=os.path.join(tempfile.gettempdir(),
                                             "gs_trace"))
    parser.add_argument("--analyze-only", type=str, default=None)
    parser.add_argument("--grad", action="store_true",
                        help="profile the fwd+bwd step instead of forward")
    parser.add_argument("--rgb-only", action="store_true",
                        help="inference path (bench.py protocol)")
    parser.add_argument("--fit-cap", action="store_true",
                        help="fit key_cap to the live key count (bench.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (no device time)")
    args = parser.parse_args(argv)
    if args.analyze_only:
        return analyze(args.analyze_only, args.runs)
    info = capture(args.out, args.points, args.runs, grad=args.grad,
                   rgb_only=args.rgb_only, fit_cap=args.fit_cap,
                   device=args.device)
    return dict(info, **analyze(info["trace"], args.runs))


if __name__ == "__main__":
    main()
