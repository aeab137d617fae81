#!/usr/bin/env python3
"""Where the blend kernels' time goes, on one NVIDIA card (H100).

    python3 kernel_variants/blend_step0.py [--out record.json]

Builds the first design of the blend kernels (``blend_backward_v1.cu``,
``blend_v1.cu`` in this directory) in variants, next to the package's own
``csrc/blend.cu`` and ``csrc/blend_backward.cu``, and at the full-width
frame of ``chip_smoke.py`` (428,687 points, 960x544, 32x32 tiles):

1. prints ``ptxas -v`` (registers, shared memory, spills) of every build;
2. counts the (pixel, key) pairs the kernels walk at three granularities
   and the warp key steps the per-warp cull keeps
   (``chip_smoke.walked_pairs``), and a greedy schedule of the tiles' key
   steps on 132 SMs in grid order and heaviest tile first;
3. times the first design's blend_backward (a) as it was, (b) with its
   shuffle reduction replaced by lane 0 writing zeros, (c) with 64 keys
   between reductions, and its blend_forward, each in grid order and with
   the tiles heaviest first (CUDA events over 20 launches, two rounds);
4. holds the package's kernels against the first design: blend_forward's
   output and blend_backward's counts and image bit for bit (each pixel
   takes the same operations in the same order), its rows within the
   gradient gate 5e-4 + 1e-3 |first| (the pixel sums group otherwise), two
   package runs bit-identical; then times both in turns (first, package,
   package, first; CUDA events over whole calls) and the package kernels'
   own device time a launch (torch.profiler).

Needs the card and nvcc; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

VARIANTS = {  # name: (source, extra nvcc flags)
    "k4_a": ("blend_backward_v1.cu", []),
    "k4_b_zero_reduction": ("blend_backward_v1.cu", ["-DZERO_RED"]),
    "k4_c_sub64": ("blend_backward_v1.cu", ["-DSUB_N=64"]),
    "k3_a": ("blend_v1.cu", []),
}


def build(build_dir: Path) -> None:
    from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

    nvcc = cuda_build.nvcc_path()
    jobs = {n: (HERE / src, extra) for n, (src, extra) in VARIANTS.items()}
    for pkg in ("blend", "blend_backward"):
        jobs["package_" + pkg] = (cuda_build.CSRC / f"{pkg}.cu", [])
    procs = {n: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", *extra, "-o",
         str(build_dir / f"{n}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, (src, extra) in jobs.items()}
    failed = []
    for n, p in procs.items():
        log, _ = p.communicate()
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln or "Compiling entry" in ln]
        print(f"nvcc {n}: rc {p.returncode}; " + "; ".join(used), flush=True)
        if p.returncode:
            print(log)
            failed.append(n)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    cuda_build.build_all()


def greedy_makespan(costs: np.ndarray, order: np.ndarray, sms: int = 132):
    """Largest SM load when each tile in ``order`` goes to the least-loaded
    SM (the hardware's in-order block dispatch, one block an SM)."""
    load = np.zeros(sms)
    for c in costs[order]:
        load[np.argmin(load)] += c
    return float(load.max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_step0: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend, cuda_build
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    card = cs.card_line()
    print(card, flush=True)
    tmp = tempfile.TemporaryDirectory()
    build_dir = Path(tmp.name)
    build(build_dir)

    dev = torch.device("cuda")
    R.pin_f32_matmul()
    xyz, feats = cs.truck_scene_surround(cs.N_POINTS)
    K = np.asarray([[580.0, 0.0, cs.WIDTH / 2], [0.0, 580.0, cs.HEIGHT / 2],
                    [0.0, 0.0, 1.0]], np.float32)
    scene = scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                   features=feats, device="cuda")
    cam = R.Camera(torch.from_numpy(K).to(dev), cs.WIDTH, cs.HEIGHT)
    full = cs.Frame(scene.xyz, scene.features, scene.invalid,
                    torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev),
                    torch.zeros(3, device=dev), cam,
                    R.RasterizerConfig(tile_size=cs.TILE))
    k = full.keys
    table, cap, nt = full.table, full.table.shape[1], full.num_tiles
    stream = cuda_build.stream_of(table)
    rec = {"card": card}

    # 2. counts and the schedule of the tiles
    counts = cs.walked_pairs(full)
    per_tile = np.asarray(counts.pop("tile_block_keys"), np.float64)
    n_keys = (k.tile_end - k.tile_start).clamp_min(0)
    heavy = torch.argsort(n_keys, descending=True, stable=True)
    rec["walked_pairs"] = counts
    rec["schedule_block_key_steps"] = {
        "tiles": nt, "max": float(per_tile.max()),
        "mean": float(per_tile.mean()), "sum": float(per_tile.sum()),
        "even_split": float(per_tile.sum() / 132),
        "grid_order": greedy_makespan(per_tile, np.arange(nt)),
        "heaviest_first_by_key_count": greedy_makespan(
            per_tile, heavy.cpu().numpy())}
    print(f"walked pairs: {counts}\nschedule: "
          f"{rec['schedule_block_key_steps']}", flush=True)

    # 3. the first design's variants
    cfin = blend.blend_forward(table, k.tile_start, k.tile_end, rgb_only=True,
                               **full.blend_kw)[..., 0:3].contiguous()
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(cfin.shape)).astype(np.float32)).to(dev)
    heavy_i32 = heavy.int().contiguous()

    def k4_v1(lib_name, order, d_table, img):
        f = ctypes.CDLL(str(build_dir / f"{lib_name}.so")).blend_backward_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int

        def run():
            err = f(table.data_ptr(), cap, k.tile_start.data_ptr(),
                    k.tile_end.data_ptr(), g.data_ptr(), cfin.data_ptr(), nt,
                    32, 32, 1, 1, d_table.data_ptr(), img.data_ptr(), stream,
                    order)
            assert err == 0, f"{lib_name}: cudaError_t {err}"
        return run

    def k3_v1(order, out, rgb_only=True):
        f = ctypes.CDLL(str(build_dir / "k3_a.so")).blend_forward_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int

        def run():
            err = f(table.data_ptr(), cap, k.tile_start.data_ptr(),
                    k.tile_end.data_ptr(), nt, 32, 32, int(rgb_only),
                    out.data_ptr(), stream, order)
            assert err == 0, f"k3_a: cudaError_t {err}"
        return run

    d_scratch = torch.zeros((16, cap), device=dev)
    img_scratch = torch.empty((nt, 1024, 2), device=dev)
    out_scratch = torch.empty((nt, 1024, 8), device=dev)
    runs = {}
    for name in ("k4_a", "k4_b_zero_reduction", "k4_c_sub64", "k3_a"):
        for label, order in (("grid", None),
                             ("heaviest_first", heavy_i32.data_ptr())):
            runs[f"{name} {label}"] = (
                k3_v1(order, out_scratch) if name == "k3_a" else
                k4_v1(name, order, d_scratch, img_scratch))
    times = {}
    for _ in range(2):
        for name, fn in runs.items():
            times.setdefault(name, []).append(cs.cuda_ms(fn, reps=20))
    rec["first_design_variants_ms"] = times
    for name, v in times.items():
        print(f"{name}: {v} ms a launch", flush=True)

    # 4. the package's kernels against the first design
    same = {}
    for rgb_only in (True, False):
        want = torch.empty((nt, 1024, 8), device=dev)
        k3_v1(None, want, rgb_only)()
        got = blend.blend_forward(table, k.tile_start, k.tile_end,
                                  rgb_only=rgb_only, **full.blend_kw)
        same[f"blend_forward rgb_only={rgb_only}"] = torch.equal(got, want)
    d_want = torch.zeros((16, cap), device=dev)
    img_want = torch.empty((nt, 1024, 2), device=dev)
    k4_v1("k4_a", None, d_want, img_want)()
    d_got, img_got = blend.blend_backward(table, k.tile_start, k.tile_end, g,
                                          cfin, **full.blend_kw)
    d_again, img_again = blend.blend_backward(table, k.tile_start, k.tile_end,
                                              g, cfin, **full.blend_kw)
    torch.cuda.synchronize()
    rows = [0, 1, 2, 3, 4, 5, 6, 7, 8, 10]
    excess = float(((d_got[rows] - d_want[rows]).abs()
                    - (5e-4 + 1e-3 * d_want[rows].abs())).max())
    rec["blend_backward_rows_vs_first_design"] = {
        "bit_identical": torch.equal(d_got, d_want),
        "max_abs": cs.max_abs(d_got[rows], d_want[rows]),
        "worst_excess_over_gate": excess}
    same["blend_backward rows within 5e-4 + 1e-3 |first|"] = excess <= 0
    same["blend_backward counts"] = torch.equal(d_got[11], d_want[11])
    same["blend_backward image"] = torch.equal(img_got, img_want)
    same["blend_backward repeats"] = (torch.equal(d_got, d_again)
                                      and torch.equal(img_got, img_again))
    rec["checks_against_first_design"] = same
    print(f"against the first design: {same}; rows "
          f"{rec['blend_backward_rows_vs_first_design']}", flush=True)

    def k4_first():
        d_scratch.zero_()
        k4_v1("k4_a", None, d_scratch, img_scratch)()

    calls = {
        "blend_forward first": k3_v1(None, out_scratch),
        "blend_forward package": lambda: blend.blend_forward(
            table, k.tile_start, k.tile_end, rgb_only=True, **full.blend_kw),
        "blend_backward first": k4_first,
        "blend_backward package": lambda: blend.blend_backward(
            table, k.tile_start, k.tile_end, g, cfin, **full.blend_kw),
    }
    turns = {}
    for kern in ("blend_forward", "blend_backward"):
        for who in ("first", "package", "package", "first"):
            name = f"{kern} {who}"
            turns.setdefault(name, []).append(cs.cuda_ms(calls[name], reps=20))
    rec["call_ms_in_turns"] = turns
    rec["package_kernel_ms"] = {
        "blend_forward_kernel": cs.kernel_ms(
            calls["blend_forward package"], "blend_forward_kernel", reps=20),
        "blend_backward_kernel": cs.kernel_ms(
            calls["blend_backward package"], "blend_backward_kernel",
            reps=20),
        "tile_order_kernel": cs.kernel_ms(
            calls["blend_backward package"], "tile_order_kernel", reps=20)}
    print(f"whole calls in turns (ms): {turns}\npackage kernels (ms a "
          f"launch): {rec['package_kernel_ms']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    tmp.cleanup()
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
