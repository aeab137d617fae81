"""The readings a cell's limits are set from, on the card at the cell's
own size, in one process: the program's numbers on many seeds (sound
runs, each with a short window), the control's (the plain reference put
in the program's place, computed in TF32, one step below the float32 the
configurations state), and, in the train cells, the planted faults'.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 \\
        --first-seed <n> --seconds 1 --control 3 --faults 3

Prints one JSON line a reading; ``limits/<cell>.json`` is set from them
by hand, as PERF.md records. A cell on several chips runs the program's
seeds and its faults (``rank_left_out`` besides) in one process group
(``ranks.run_jobs``), then the control on this process's card alone.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cells, drive, ranks  # noqa: E402
from perfbench.reference import splat  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The train step's loss taken over the top half of the image's rows
    alone (the mean over the rest): half of the batch left out."""
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    whole = trainer.compute_loss

    def half(pred, target, cfg, **kw):
        h = pred.shape[0] // 2
        return whole(pred[:h], target[:h], cfg, **kw)
    trainer.compute_loss = half
    try:
        yield
    finally:
        trainer.compute_loss = whole


@contextlib.contextmanager
def state_unchanged():
    """Every train step (one card's or data-parallel) returns the state it
    was given."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        data_parallel as dp,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    apply = trainer.apply_grads

    def same(state, optimizers, d_xyz, d_features, ctrl_state, pose=None):
        return state
    trainer.apply_grads = dp.apply_grads = same
    try:
        yield
    finally:
        trainer.apply_grads = dp.apply_grads = apply


@contextlib.contextmanager
def rank_left_out():
    """The last rank's sums left out of the data-parallel step's SUM: it
    adds zeros to the others' and goes on with its own unreduced sums."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    whole = mh.all_reduce_packed

    def left_out(tensors, op="sum", dtype=torch.float32, group=None,
                 log=None):
        if op != "sum" or mh.rank() != mh.world_size() - 1:
            return whole(tensors, op, dtype, group, log)
        whole([torch.zeros_like(t) for t in tensors], op, dtype, group, log)
        return [t.to(dtype) for t in tensors]
    mh.all_reduce_packed = left_out
    try:
        yield
    finally:
        mh.all_reduce_packed = whole


@contextlib.contextmanager
def answer_altered():
    """Every rendered image darkened by a tenth in its top half where the
    rasterizer produces it (frames, and a train step's prediction)."""
    from taichi_3d_gaussian_splatting_tpu_torch.apps import render as app
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    capped, fwd = app.GaussianPointRenderer.render_capped, \
        trainer.rasterize_fwd_ctx

    def dark(rgb):
        h = rgb.shape[0] // 2
        return torch.cat([rgb[:h] * 0.9, rgb[h:]], 0)

    def render_capped(self, q, t):
        rgb, over = capped(self, q, t)
        return dark(rgb), over

    def rasterize_fwd_ctx(*a, **kw):
        out, ctx, vjp = fwd(*a, **kw)
        return out._replace(rgb=dark(out.rgb)), ctx, vjp
    app.GaussianPointRenderer.render_capped = render_capped
    trainer.rasterize_fwd_ctx = rasterize_fwd_ctx
    try:
        yield
    finally:
        app.GaussianPointRenderer.render_capped = capped
        trainer.rasterize_fwd_ctx = fwd


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "answer_altered": answer_altered, "rank_left_out": rank_left_out}


def outcome_row(o) -> dict:
    """A reading of a run on several ranks (``ranks.Outcome``)."""
    return {"numbers": o.numbers, "detail": getattr(o.driver, "detail", None),
            "attempted": o.win.attempted, "failed": o.win.failed,
            "setup_s": o.setup_s,
            "step_or_frame_ms": o.win.wall_s * 1e3 / o.win.attempted,
            "memory_peak": o.memory_peak}


def program_numbers(cell, seed: int, seconds: float, device) -> dict:
    """One run of the program's timed path, its window cut short."""
    if cell.chips > 1:
        return outcome_row(ranks.run_jobs(cell, [ranks.Job(seed)], seconds,
                                          False, str(device))[0])
    d = drive.driver_class(cell.kind)(cell, seed, device)
    t0 = time.perf_counter()
    d.setup()
    t1 = time.perf_counter()
    win = d.window(seconds)
    t2 = time.perf_counter()
    numbers = d.check()
    t3 = time.perf_counter()
    return {"numbers": numbers, "detail": getattr(d, "detail", None),
            "attempted": win.attempted,
            "failed": win.failed, "setup_s": t1 - t0,
            "step_or_frame_ms": win.wall_s * 1e3 / win.attempted,
            "check_s": t3 - t2}


def control_numbers(cell, seed: int, device) -> dict:
    """The reference in the program's place, computed in TF32."""
    d = drive.driver_class(cell.kind)(cell, seed, device)
    t0 = time.perf_counter()
    if d.reads_as == "train":
        d.u8 = d.targets()
        numbers = d.reference_numbers(d.reference_steps("tf32"), "f32")
        numbers = dict(numbers, detail=d.detail)
    else:
        xyz, feats = d.scene()
        with splat.precision("tf32"):
            frames = {i: d.reference_frame(xyz, feats, i)
                      for i in range(d.n_poses)}
        numbers = {"frame_gap": d.frame_gap(frames, "f32")}
    return {"numbers": numbers, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    seeds = [args.first_seed + 7919 * i
             for i in range(max(args.seeds, args.control, args.faults))]
    faults = (["half_batch", "answer_altered"]
              if drive.driver_class(cell.kind).reads_as == "train" else [])
    if cell.chips > 1:
        faults.append("rank_left_out")
        return several_ranks(cell, seeds, faults, args, dev)
    jobs = [("program", s, None) for s in seeds[:args.seeds]]
    jobs += [("control", s, None) for s in seeds[:args.control]]
    jobs += [(f, s, f) for f in faults for s in seeds[:args.faults]]
    for what, seed, fault in jobs:
        row = {"workload": cell.name, "what": what, "seed": seed}
        try:
            if what == "control":
                row.update(control_numbers(cell, seed, dev))
            elif fault is not None:
                with FAULTS[fault]():
                    row.update(program_numbers(cell, seed, args.seconds,
                                               dev))
            else:
                row.update(program_numbers(cell, seed, args.seconds, dev))
        except Exception:  # report and go on with the next reading
            row["error"] = traceback.format_exc()[-3000:]
        print(json.dumps(row), flush=True)
        drive._free(dev)
    return 0


def several_ranks(cell, seeds: list, faults: list, args, dev) -> int:
    """The readings of a cell on several ranks: the program's seeds and the
    faults' in one process group (``ranks.run_jobs``), then the control
    here."""
    jobs = [("program", s, None) for s in seeds[:args.seeds]]
    jobs += [(f, s, f) for f in faults for s in seeds[:args.faults]]
    if jobs:
        t0 = time.perf_counter()
        try:
            # the ranks' group lines go to standard error: one reading a line
            with contextlib.redirect_stdout(sys.stderr):
                outcomes = ranks.run_jobs(
                    cell, [ranks.Job(s, FAULTS[f] if f else None)
                           for _, s, f in jobs], args.seconds, False,
                    args.device)
        except ranks.RankFailed:
            print(json.dumps({"workload": cell.name, "error":
                              traceback.format_exc()[-3000:]}), flush=True)
            return 1
        for (what, seed, _), o in zip(jobs, outcomes):
            print(json.dumps(dict({"workload": cell.name, "what": what,
                                   "seed": seed}, **outcome_row(o))),
                  flush=True)
        print(json.dumps({"workload": cell.name, "jobs": len(jobs),
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in seeds[:args.control]:
        row = {"workload": cell.name, "what": "control", "seed": seed}
        row.update(control_numbers(cell, seed, dev))
        print(json.dumps(row), flush=True)
        drive._free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
