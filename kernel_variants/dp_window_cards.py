#!/usr/bin/env python3
"""Data-parallel windows on several cards over NCCL, each rank on a card
of its own: ``make_dp_train_step(scan_steps)`` at world > 1.

    python3 kernel_variants/dp_window_cards.py [--ranks 4] [--out r.json]
    python3 kernel_variants/dp_window_cards.py --ranks 4 --graph
    python3 kernel_variants/dp_window_cards.py --device cpu --ranks 4 \\
        --points 2000 --width 128 --height 64      # a rehearsal over gloo

Each rank trains chip_smoke.py's phase-4 scene (428,687 points, 960x544,
32-px tiles, SH 3) from the same start state; at step s rank r takes view
``ranks * s + r`` of ``chip_smoke.poses()`` (targets rendered as phase 10's).
Per rank: a window of 8 capped steps at ``fit_key_cap`` of the views'
largest key total, (i) as the window runs in this group (``window_mode``:
its steps in a loop at world > 1) or, with ``--graph``, as one CUDA graph
with its collectives captured (the probe of the open question in ROADMAP
C: whether such a capture completes at world > 1) and (ii) as 8 eager
capped data-parallel steps from the same state; they must agree bit for bit, over two calls of the window, and the
ranks' states must be bit-identical. Then ms a step over warm windows
(host clock between device syncs) beside the eager step's, and the
window's capture time.
With ``--release`` a rank drops its window's graph before it leaves the
process group.
Prints one JSON line per rank and exits 1 if a check fails or, without
``--device cpu``, when fewer cards than ranks are visible. Each rank prints
its progress as it goes, and its threads' stacks when it has printed no
stage for ``--stack_dump_s`` seconds (a hang in the teardown after its
last stage shows so too).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WINDOW = 8
STACK_DUMP_S = [240.0]


def stage(*a) -> None:
    """A rank's progress line, flushed at once (a hang shows where); the
    rank's stacks are printed if no other stage follows within
    ``--stack_dump_s``."""
    import faulthandler
    import os

    print(f"[rank {os.environ.get('LOCAL_RANK')} {time.perf_counter():.1f}]",
          *a, flush=True)
    faulthandler.dump_traceback_later(STACK_DUMP_S[0], exit=False)


def rank_main(points: int, width: int, height: int, device: str,
              stack_dump_s: float, graph: bool, release: bool) -> dict:
    import gc

    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.parallel.data_parallel import (
        make_dp_train_step,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training import (
        checkpoint,
        trainer,
    )

    STACK_DUMP_S[0] = stack_dump_s
    stage("start")
    on_card = device == "cuda"
    if on_card:
        R.pin_f32_matmul()
    dev = mh.rank_device(device)
    world, rank = mh.world_size(), mh.rank()
    xyz, feats = cs.truck_scene_surround(points)
    camera = cs.full_camera(height, width, dev)
    config, step, start, inputs = cs.train_setup(
        xyz, feats, camera, {"tile_size": cs.TILE}, device=dev)
    band = inputs[4]
    views = cs.view_targets(start, feats, camera,
                            list(range(world * WINDOW)),
                            {"tile_size": cs.TILE})
    totals = [int(R.rasterize(start.scene.xyz, start.scene.features,
                              start.scene.invalid, q, t, camera,
                              R.RasterizerConfig(tile_size=cs.TILE),
                              return_num_keys=True)[1])
              for _, q, t, _ in views]
    cap = trainer.fit_key_cap(max(totals))
    rows = cs.window_rows(views, [[world * s + rank]
                                  for s in range(WINDOW)])
    stage("views", len(views), "key_cap", cap)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    capped = make_dp_train_step(config, height, width, device=dev,
                                key_cap=cap)
    eager, losses = start, []
    t0 = time.perf_counter()
    for i in range(WINDOW):
        eager, m, _ = capped(eager, *(x[i] for x in rows), band)
        losses.append(m["loss"])
    sync()
    eager_ms = (time.perf_counter() - t0) * 1e3 / WINDOW
    want = [t.clone() for t in checkpoint.state_leaves(eager)]
    want_losses = torch.stack(losses)
    del eager
    stage("eager steps", eager_ms)

    window = make_dp_train_step(config, height, width, device=dev,
                                scan_steps=WINDOW, key_cap=cap)
    if graph:
        window.mode = "graph"
    equal = []
    for _ in range(2):  # the capture and a replay, each from the start
        got, wm, _ = window(start, *rows, band)
        equal.append(all(torch.equal(a, b) for a, b in zip(
            checkpoint.state_leaves(got), want))
            and torch.equal(wm["loss"], want_losses))
        stage("window call", window.mode, window.captures, equal[-1])
    digest = cs.state_digest(got)
    state = got
    sync()
    t0 = time.perf_counter()
    for _ in range(5):
        state = window(state, *rows, band)[0]
    sync()
    window_ms = (time.perf_counter() - t0) * 1e3 / (5 * WINDOW)
    stage("timed windows", window_ms)
    graph = next(iter(window.graphs.values()), None)
    res = {"rank": rank, "world": world, "backend": mh.dist.get_backend(),
           "device": str(dev), "card": (torch.cuda.get_device_name(dev)
                                        if on_card else "cpu"),
           "mode": window.mode, "captures": window.captures,
           "key_cap": cap, "key_totals": totals,
           "window_equals_eager_steps": equal, "digest": digest,
           "losses": [float(v) for v in wm["loss"]],
           "window_ms_per_step": window_ms, "eager_ms_per_step": eager_ms,
           "capture_s": None if graph is None else graph.capture_s}
    if release:
        del graph
        window.graphs.clear()
        gc.collect()
        sync()
    stage("leaving the process group")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--points", type=int, default=cs.N_POINTS)
    ap.add_argument("--width", type=int, default=cs.WIDTH)
    ap.add_argument("--height", type=int, default=cs.HEIGHT)
    ap.add_argument("--stack_dump_s", type=float, default=240.0,
                    help="a rank still running after this many seconds "
                    "prints its threads' stacks")
    ap.add_argument("--graph", action="store_true",
                    help="capture the window as one CUDA graph, whatever "
                    "the group (window_mode keeps world > 1 eager)")
    ap.add_argument("--release", action="store_true",
                    help="drop the window's graph before the teardown")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"dp_window_cards: {torch.cuda.device_count()} cards for "
                  f"{args.ranks} ranks", file=sys.stderr)
            return 1
        print(cs.card_line(), flush=True)
        cuda_build.build_all()
    t0 = time.perf_counter()
    res = mh.run_local_ranks(rank_main, args.ranks, args=(
        args.points, args.width, args.height, args.device,
        args.stack_dump_s, args.graph, args.release),
        device=args.device, timeout_s=900)
    for r in res:
        print(json.dumps(r), flush=True)
    ok = (len({r["digest"] for r in res}) == 1
          and all(all(r["window_equals_eager_steps"]) for r in res)
          and all(r["mode"] == ("graph" if args.graph else "eager")
                  for r in res))
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
