#!/usr/bin/env python3
"""Where the key expansion's (K1) and the segment sum's (K5) time goes, on
one NVIDIA card (H100), and the first design of both against the package's.

    python3 kernel_variants/keys_step0.py [--out record.json]

Builds the first design of K1 and K5 (``expand_v1.cu``,
``segment_reduce_v1.cu`` in this directory: the port's kernels before
their redesign, which wrote the table before the sort and summed rows
regrouped to pre-sort order) next to the package's ``csrc/expand.cu`` and
``csrc/segment_reduce.cu``, and then:

1. prints ``ptxas -v`` (registers, shared memory, spills) of every build;
2. holds the package's K1a, K1b and K5 against the first design bit for
   bit, at the 64x64 frame and the full-width frame of ``chip_smoke.py``
   (428,687 points, 960x544, 32x32 tiles): the fused keys, the sort's
   permutation, the sorted table (the first design's pre-sort table
   gathered by the permutation), and K5's per-point rows (the first
   design's regroup + kernel);
3. at the full-width frame: the segment lengths (keys a point), and each
   stage around K1 and K5 alone in both designs (step 0 for the first
   design: its K1, the sort, the table gather, the regroup, its K5), by
   CUDA events over 20 calls and by the device time of the same calls
   under torch.profiler;
4. both designs' K1 path (first: K1 + the table gather; package: K1a +
   K1b) and K5 path (first: regroup + K5; package: inverse permutation +
   K5) in turns, first, package, package, first, and K5's library chain
   (index_copy_ + torch.segment_reduce).

Needs the card and nvcc; exits 1 without a card, and 1 when a
bit-identity check fails.
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

V1_SOURCES = {"expand_v1": "expand_v1.cu",
              "segment_reduce_v1": "segment_reduce_v1.cu"}


def build_v1(build_dir: Path, ptxas: bool = False) -> dict:
    """Build the first design's K1 and K5 into ``build_dir`` (one nvcc each,
    in parallel, with the package's flags and headers) and, with
    ``ptxas``, the package's expand and segment_reduce beside them for
    their ``ptxas -v``. Returns {name: ptxas lines}."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

    nvcc = cuda_build.nvcc_path()
    jobs = {n: HERE / src for n, src in V1_SOURCES.items()}
    if ptxas:
        for pkg in ("expand", "segment_reduce"):
            jobs["package_" + pkg] = cuda_build.CSRC / f"{pkg}.cu"
    extra = ["-Xptxas", "-v"] if ptxas else []
    procs = {n: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, *extra, "-I", str(cuda_build.CSRC),
         "-o", str(build_dir / f"{n}.so"), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, src in jobs.items()}
    used, failed = {}, []
    for n, p in procs.items():
        log, _ = p.communicate()
        used[n] = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                   if "Used" in ln or "Compiling entry" in ln]
        if p.returncode:
            print(log)
            failed.append(n)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}")
    return used


class FirstDesign:
    """The first design's K1 (``expand_keys_launch``: keys and the
    pre-sort table) and K5 (``segment_reduce_launch``: rows in pre-sort
    order), bound from the libraries that ``build_v1`` made."""

    def __init__(self, build_dir: Path):
        self.k1 = ctypes.CDLL(str(build_dir / "expand_v1.so")).expand_keys_launch
        self.k1.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        self.k1.restype = ctypes.c_int
        self.k5 = ctypes.CDLL(
            str(build_dir / "segment_reduce_v1.so")).segment_reduce_launch
        self.k5.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
        self.k5.restype = ctypes.c_int

    def expand_keys(self, offsets, counts, dkey, base, h, att, *, total,
                    tiles_u, tile_w, tile_h, dbits, sentinel, exact_cull,
                    out=None):
        """``att``: (10, N) row-major, as the first design read it."""
        from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build, expand

        assert att.is_contiguous(), "the first K1 reads row-major columns"
        fused, table = out if out is not None else (
            torch.empty((total,), dtype=torch.int32, device=offsets.device),
            torch.empty((16, total), device=offsets.device))
        err = self.k1(offsets.data_ptr(), dkey.data_ptr(), base.data_ptr(),
                      h.data_ptr(), att.data_ptr(), offsets.shape[0], total,
                      tiles_u, tile_w, tile_h, dbits, sentinel,
                      int(exact_cull), expand.CULL_BIAS, fused.data_ptr(),
                      table.data_ptr(), cuda_build.stream_of(offsets))
        assert err == 0, f"first K1: cudaError_t {err}"
        return fused, table

    def segment_reduce(self, rows, offsets, counts, out=None):
        from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

        n = offsets.shape[0]
        if out is None:
            out = torch.empty((rows.shape[0], n), device=rows.device)
        err = self.k5(rows.data_ptr(), rows.shape[0], rows.shape[1],
                      offsets.data_ptr(), counts.data_ptr(), n,
                      out.data_ptr(), cuda_build.stream_of(rows))
        assert err == 0, f"first K5: cudaError_t {err}"
        return out


def timed(fn, expect: tuple, reps: int = 20) -> dict:
    """CUDA-event ms of one call over ``reps`` back-to-back calls (the
    larger of the host's and the device's rate) and the device ms of one
    call (torch.profiler: the kernels, copies and sets it runs, in a window
    that shows the events named in ``expect``, ``chip_smoke.profiled``)."""
    import chip_smoke as cs

    return {"events_ms": cs.cuda_ms(fn, reps),
            "device_ms": cs.device_ms(fn, reps, expect)}


# parts of the names of the device events each timed call must show
K1_FIRST, K5 = ("expand_kernel(",), ("segment_reduce_kernel(",)
K1_PACKAGE = ("slot_keys_kernel(", "sorted_table_kernel(")
K4 = ("blend_backward_kernel(",)
GATHER = ("scatter_gather",)  # index_select along the keys
REGROUP = ("index_copy",)


def segment_lengths(counts: torch.Tensor) -> dict:
    """Keys a point, and what one thread a point costs a warp: its key steps
    are the longest segment among its 32 points."""
    c = counts.long().cpu().numpy()
    live = c[c > 0]
    pad = (-len(c)) % 32
    warp_max = np.concatenate([c, np.zeros(pad, c.dtype)]).reshape(-1, 32).max(1)
    out = {"points": int(len(c)), "points_with_keys": int(len(live)),
           "keys": int(c.sum()), "max": int(c.max()) if len(c) else 0,
           "quantiles_of_points_with_keys": {
               str(q): float(np.quantile(live, q)) if len(live) else 0.0
               for q in (0.5, 0.9, 0.99, 0.999)},
           "warp_key_steps_one_thread_a_point": int(warp_max.sum()),
           "warp_key_steps_even": float(c.sum() / 32)}
    for t in (4, 8, 16, 32, 64):
        long_ = c > t
        out[f"keys_in_segments_over_{t}"] = int(c[long_].sum())
        out[f"points_over_{t}"] = int(long_.sum())
    return out


def blend_backward_call(frame):
    """A call of K4 at the frame, for a seeded rgb cotangent and the
    forward's own rgb: its d_table rows 0..11 are the rows K5 sums."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import blend

    k = frame.keys
    cfin = blend.blend_forward(frame.table, k.tile_start, k.tile_end,
                               rgb_only=True, **frame.blend_kw)[..., 0:3]
    cfin = cfin.contiguous()
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(cfin.shape)).astype(np.float32)).to(cfin.device)
    return lambda: blend.blend_backward(frame.table, k.tile_start,
                                        k.tile_end, g, cfin,
                                        **frame.blend_kw)[0]


def backward_rows(frame) -> torch.Tensor:
    """K4's rows 0..11 at the frame (``blend_backward_call``)."""
    return blend_backward_call(frame)()[0:12]


def frames():
    """chip_smoke.py's 64x64 frame and its full-width frame."""
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    dev = torch.device("cuda")
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    t = torch.zeros(3, device=dev)
    small = cs.small_frame(dev)
    xyz, feats = cs.truck_scene_surround(cs.N_POINTS)
    K = np.asarray([[580.0, 0.0, cs.WIDTH / 2], [0.0, 580.0, cs.HEIGHT / 2],
                    [0.0, 0.0, 1.0]], np.float32)
    scene = scene_lib.create_scene(xyz, scene_lib.SceneConfig(),
                                   features=feats, device="cuda")
    cam = R.Camera(torch.from_numpy(K).to(dev), cs.WIDTH, cs.HEIGHT)
    full = cs.Frame(scene.xyz, scene.features, scene.invalid, q, t, cam,
                    R.RasterizerConfig(tile_size=cs.TILE))
    return small, full


def check_against_first(first: FirstDesign, frame, label: str) -> dict:
    """The package's K1a + K1b and K5 against the first design, bit for
    bit (chip_smoke.check_expand for the keys and the table)."""
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

    out = {}
    try:
        cs.check_expand(frame, label, first)
        out["keys, orig_slot, sorted table"] = True
    except AssertionError as e:
        print(e, flush=True)
        out["keys, orig_slot, sorted table"] = False
    k = frame.keys
    rows = backward_rows(frame)
    seg = sr.segment_reduce_sorted(rows, tiling.inverse_permutation(
        k.orig_slot), k.offsets, k.counts)
    seg_1 = first.segment_reduce(tiling.regroup_rows_by_slot(
        rows, k.orig_slot), k.offsets, k.counts)
    torch.cuda.synchronize()
    out["K5 rows"] = torch.equal(seg, seg_1)
    print(f"{label} against the first design: {out}", flush=True)
    return out


def first_design_stages(first: FirstDesign, frame, rows) -> dict:
    """Each stage of the first design around K1 and K5 alone (step 0), at
    the frame and K4's rows; the sort is both designs'."""
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

    k = frame.keys
    perm = k.orig_slot
    fused, table = first.expand_keys(*frame.expand_args, **frame.expand_kw)
    out1 = (torch.empty_like(fused), torch.empty_like(table))
    d_orig = tiling.regroup_rows_by_slot(rows, perm)
    seg = torch.empty((rows.shape[0], k.offsets.shape[0]), device=rows.device)
    stages = {
        "first: K1 (keys and pre-sort table)": (lambda: first.expand_keys(
            *frame.expand_args, **frame.expand_kw, out=out1), K1_FIRST),
        "both: torch.sort(fused, stable=True)": (lambda: torch.sort(
            fused, stable=True), cs.SORT),
        "first: table.index_select(1, perm)": (lambda: table.index_select(
            1, perm), GATHER),
        "first: regroup_rows_by_slot (12 rows)": (lambda: (
            tiling.regroup_rows_by_slot(rows, perm)), REGROUP),
        "first: K5 (pre-sort rows)": (lambda: first.segment_reduce(
            d_orig, k.offsets, k.counts, out=seg), K5),
    }
    return {name: timed(*fe) for name, fe in stages.items()}


def package_stages(first: FirstDesign, frame, rows) -> dict:
    """The package's stages around K1 and K5 alone, and K5 of both designs
    as the train step meets it, right after K4 has written the rows: (K4
    then K5) less K4 alone."""
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.ops import expand
    from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

    k = frame.keys
    perm = k.orig_slot
    _, owner = expand.slot_keys(*frame.expand_args, **frame.expand_kw)
    inv = tiling.inverse_permutation(perm)
    seg = torch.empty((rows.shape[0], k.offsets.shape[0]), device=rows.device)
    k4 = blend_backward_call(frame)
    stages = {
        "package: K1a slot_keys": (lambda: expand.slot_keys(
            *frame.expand_args, **frame.expand_kw), K1_PACKAGE[:1]),
        "package: K1b sorted_table": (lambda: expand.sorted_table(
            k.fused, perm, owner, frame.expand_args[5], **frame.table_kw),
            K1_PACKAGE[1:]),
        "package: inverse_permutation": (lambda: tiling.inverse_permutation(
            perm), cs.EW),
        "package: K5 segment_reduce_sorted": (lambda: sr.segment_reduce_sorted(
            rows, inv, k.offsets, k.counts), K5),
        "K4 alone": (k4, K4),
        "K4, then the first design's regroup + K5": (
            lambda: first.segment_reduce(
                tiling.regroup_rows_by_slot(k4()[0:12], perm), k.offsets,
                k.counts, out=seg), K4 + REGROUP + K5),
        "K4, then the package's K5": (lambda: sr.segment_reduce_sorted(
            k4()[0:12], inv, k.offsets, k.counts), K4 + K5),
    }
    return {name: timed(*fe) for name, fe in stages.items()}


def paths_in_turns(first: FirstDesign, frame, rows) -> dict:
    """Both designs' K1 path (after the sort's keys: the first design's K1
    and table gather; K1a and K1b) and K5 path (the first design's regroup
    and K5; the inverse permutation and K5), in turns, first, package,
    package, first; and K5's library chain."""
    from taichi_3d_gaussian_splatting_tpu_torch.ops import expand
    from taichi_3d_gaussian_splatting_tpu_torch.ops import segment_reduce as sr
    from taichi_3d_gaussian_splatting_tpu_torch.ops import tiling

    k = frame.keys
    perm = k.orig_slot
    att = frame.expand_args[5]
    fused, table = first.expand_keys(*frame.expand_args,
                                     **frame.expand_kw)
    out1 = (torch.empty_like(fused), torch.empty_like(table))
    seg = torch.empty((rows.shape[0], k.offsets.shape[0]), device=rows.device)

    def k1_first():
        first.expand_keys(*frame.expand_args, **frame.expand_kw,
                          out=out1)
        return out1[1].index_select(1, perm)

    def k1_package():
        _, owner = expand.slot_keys(*frame.expand_args, **frame.expand_kw)
        return expand.sorted_table(k.fused, perm, owner, att,
                                   **frame.table_kw)

    def k5_first():
        return first.segment_reduce(tiling.regroup_rows_by_slot(rows, perm),
                                    k.offsets, k.counts, out=seg)

    def k5_package():
        return sr.segment_reduce_sorted(
            rows, tiling.inverse_permutation(perm), k.offsets, k.counts)

    lengths = k.counts.long()

    def k5_library():
        d_orig = torch.empty_like(rows).index_copy_(1, perm, rows)
        return torch.segment_reduce(d_orig.T.contiguous(), "sum",
                                    lengths=lengths, axis=0, unsafe=True)

    calls = {"K1 path": {"first": (k1_first, K1_FIRST + GATHER),
                         "package": (k1_package, K1_PACKAGE)},
             "K5 path": {"first": (k5_first, REGROUP + K5),
                         "package": (k5_package, K5)}}
    out = {}
    for path, who_fn in calls.items():
        for who in ("first", "package", "package", "first"):
            out.setdefault(f"{path} {who}", []).append(timed(*who_fn[who]))
    out["K5 library chain (index_copy_ + torch.segment_reduce)"] = [
        timed(k5_library, REGROUP + ("segment_reduce",))]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write the record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("keys_step0: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R

    card = cs.card_line()
    print(card, flush=True)
    rec = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        rec["ptxas"] = build_v1(Path(tmp), ptxas=True)
        for n, lines in rec["ptxas"].items():
            print(f"ptxas {n}: " + "; ".join(lines), flush=True)
        cuda_build.build_all()
        first = FirstDesign(Path(tmp))
        R.pin_f32_matmul()
        small, full = frames()
        rec["same_as_first_design"] = {
            "64x64": check_against_first(first, small, "64x64"),
            "full": check_against_first(first, full, "full width")}
        rec["keys"] = full.expand_kw["total"]
        rec["live_keys"] = full.live_keys
        rec["segments"] = segment_lengths(full.keys.counts)
        print(f"segments: {rec['segments']}", flush=True)
        rows = backward_rows(full)
        rec["stage_ms"] = dict(first_design_stages(first, full, rows),
                               **package_stages(first, full, rows))
        for name, v in rec["stage_ms"].items():
            print(f"stage {name}: {v}", flush=True)
        rec["turns_ms"] = paths_in_turns(first, full, rows)
        for name, v in rec["turns_ms"].items():
            print(f"turns {name}: {v}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec))
    same = rec["same_as_first_design"]
    return 0 if all(all(v.values()) for v in same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
