#!/usr/bin/env python3
"""Data-parallel windows on several cards over NCCL, each rank on a card
of its own: ``make_dp_train_step(scan_steps)`` and the trainer's
``steps_per_dispatch`` windows at world > 1.

    python3 kernel_variants/dp_window_cards.py [--ranks 4] [--out r.json]
    python3 kernel_variants/dp_window_cards.py --ranks 4 --eager
    python3 kernel_variants/dp_window_cards.py --ranks 4 --loop
    python3 kernel_variants/dp_window_cards.py --ranks 4 --app
    python3 kernel_variants/dp_window_cards.py --ranks 4 --keep_graph
    python3 kernel_variants/dp_window_cards.py --device cpu --ranks 4 \\
        --points 2000 --width 128 --height 64 [--loop | --app]  # over gloo

Window (no mode flag): each rank trains chip_smoke.py's phase-4 scene
(428,687 points, 960x544, 32-px tiles, SH 3) from the same start state; at
step s rank r takes view ``ranks * s + r`` of ``chip_smoke.poses()``
(targets rendered as phase 10's). Per rank: a window of 8 capped steps at
``fit_key_cap`` of the views' largest key total, (i) as ``window_mode``
runs it in this group (one CUDA graph over NCCL, its collectives captured;
its steps in a loop over gloo) or, with ``--eager``, forced into the loop,
and (ii) as 8 eager capped data-parallel steps from the same state; they
must agree bit for bit, over two calls of the window, and the ranks'
states must be bit-identical. Then ms a step over warm windows (host clock
between device syncs) beside the eager step's, the window's capture time
and the windows ``multihost`` tracks. Nothing here releases the graph:
``multihost.shutdown`` does, as every rank leaves the group.

``--loop``: the trainer on the ranks (``data_parallel_devices`` = ranks,
``steps_per_dispatch`` 8) over phase 14d's schedule and views
(``chip_smoke.loop_config``, ``loop_views``: 40 iterations, densify rounds,
the key-capacity refit at 0, a validation with its exports and
``checkpoint_latest`` at 20), then a resume from that checkpoint; three
times (``LOOP_RUNS``): with the windows as ``window_mode`` runs them,
forced eager, and as ``window_mode`` runs them again in the warm process.
Per rank the final states must be bit for bit the same, the ranks one
digest, the windows, captures and refits the same on every rank and in
every run, and each resume equal to the state saved; each window call is
timed between device syncs.

``--app``: the loop's views written as PNGs, the scene as .parquet and a
.json config (``data_parallel_devices`` = ranks, ``steps_per_dispatch`` 8,
phase 14d's schedule), then ``python -m
taichi_3d_gaussian_splatting_tpu_torch.apps.train`` on it, which spawns
the ranks; it must exit 0 within ``--app_timeout_s``.

``--keep_graph`` (a probe, expected to hang): the window as in the first
mode, but each rank takes its graph out of ``multihost``'s tracking and
keeps it alive, so ``shutdown`` cannot release it; each rank prints its
stacks ``--stack_dump_s`` after its last stage, and the parent stops the
ranks ``--hang_s`` + 60 s after the start.

Prints the card line (``nvidia-smi``'s name and power limit), one JSON
line per rank, then ``{"ok": ...}``; exits 1 if a check fails or, without
``--device cpu``, when fewer cards than ranks are visible. Each rank
prints its progress as it goes, and its Python stacks when it has printed
no stage for ``--stack_dump_s`` seconds.
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

WINDOW = 8
# --loop's runs in order: graph windows in a fresh process, forced eager,
# then graph windows again in a process that has run the loop twice
LOOP_RUNS = (("windows", False), ("eager", True), ("windows_again", False))
STACK_DUMP_S = [240.0]
_KEPT = []  # --keep_graph: windows held past the teardown


def stage(*a) -> None:
    """A rank's progress line, flushed at once (a hang shows where); the
    rank's stacks are printed if no other stage follows within
    ``--stack_dump_s``."""
    import faulthandler
    import os

    print(f"[rank {os.environ.get('LOCAL_RANK')} {time.perf_counter():.1f}]",
          *a, flush=True)
    faulthandler.dump_traceback_later(STACK_DUMP_S[0], exit=False)


def card_lines(device: str) -> list:
    """``nvidia-smi``'s name and power limit of every card."""
    if device != "cuda":
        return ["cpu"]
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()


def camera_K(width: int, height: int) -> np.ndarray:
    return np.asarray([[580.0, 0.0, width / 2], [0.0, 580.0, height / 2],
                       [0.0, 0.0, 1.0]], np.float32)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(points: int, width: int, height: int, device: str,
              stack_dump_s: float, eager: bool, keep_graph: bool) -> dict:
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

    capped = make_dp_train_step(config, height, width, device=dev,
                                key_cap=cap)
    state, losses = start, []
    t0 = time.perf_counter()
    for i in range(WINDOW):
        state, m, _ = capped(state, *(x[i] for x in rows), band)
        losses.append(m["loss"])
    _sync(dev)
    eager_ms = (time.perf_counter() - t0) * 1e3 / WINDOW
    want = [t.clone() for t in checkpoint.state_leaves(state)]
    want_losses = torch.stack(losses)
    del state
    stage("eager steps", eager_ms)

    window = make_dp_train_step(config, height, width, device=dev,
                                scan_steps=WINDOW, key_cap=cap)
    if eager:
        window.mode = "eager"
    equal = []
    for _ in range(2):  # the capture and a replay, each from the start
        got, wm, _ = window(start, *rows, band)
        equal.append(all(torch.equal(a, b) for a, b in zip(
            checkpoint.state_leaves(got), want))
            and torch.equal(wm["loss"], want_losses))
        stage("window call", window.mode, window.captures, equal[-1])
    digest = cs.state_digest(got)
    state = got
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(5):
        state = window(state, *rows, band)[0]
    _sync(dev)
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
           "capture_s": None if graph is None else graph.capture_s,
           "tracked_windows": len(mh.live_windows())}
    if keep_graph and graph is not None:
        mh.untrack_window(graph)
        _KEPT.append(graph)
    stage("leaving the process group")
    return res


def trainer_loop(views, xyz, feats, dev, log_dir: str, force_eager: bool
                 ) -> dict:
    """Phase 14d's loop on this rank of the group (``data_parallel_devices``
    = the world), its windows as ``window_mode`` runs them or forced
    eager, then a resume from the validation's ``checkpoint_latest``."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )
    from taichi_3d_gaussian_splatting_tpu_torch.training import checkpoint

    Trainer = cs.loop_trainer_class(views[:6], views[6:], xyz, feats, [])
    over = dict(steps_per_dispatch=WINDOW,
                data_parallel_devices=mh.world_size())
    trainer = Trainer(cs.loop_config(log_dir, **over), device=dev)
    modes, refits, saved = [], [], {}
    get_step = trainer._get_step

    def get(h, w, scan_steps=0):
        fn = get_step(h, w, scan_steps)
        if scan_steps:
            if force_eager:
                fn.mode = "eager"
            modes.append(fn.mode)
        return fn

    trainer._get_step = get
    windows = cs.record_windows(trainer)
    recorded, window_ms = trainer._get_step, []

    def timed(h, w, scan_steps=0):
        fn = recorded(h, w, scan_steps)
        if not scan_steps:
            return fn

        def call(*a):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*a)
            _sync(dev)
            window_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    trainer._get_step = timed
    rebucket = trainer._maybe_rebucket_key_cap

    def recorded_rebucket(num_keys):
        before = trainer._key_cap
        grew = rebucket(num_keys)
        refits.append([num_keys, before, trainer._key_cap])
        return grew

    validate = trainer._validate

    def recorded_validate(state, iteration):
        out = validate(state, iteration)
        # the windows' state lives in their graphs' buffers, which later
        # replays overwrite: keep a copy of what the checkpoint holds
        saved.update(iteration=iteration, key_cap=trainer._key_cap,
                     leaves=[t.clone() for t in
                             checkpoint.state_leaves(state)])
        return out

    trainer._maybe_rebucket_key_cap = recorded_rebucket
    trainer._validate = recorded_validate
    _sync(dev)
    t0 = time.perf_counter()
    state = trainer.train()
    _sync(dev)
    loop_ms = (time.perf_counter() - t0) * 1e3 / cs.LOOP_ITERS
    digest = cs.state_digest(state)
    finite = bool(torch.isfinite(state.scene.features).all())
    del state
    mh.dist.barrier()  # the main rank has written checkpoint_latest
    resumed = Trainer(cs.loop_config(
        log_dir + "/resumed", num_iterations=saved["iteration"] + 1,
        resume_from=str(Path(log_dir) / "checkpoint_latest"), **over),
        device=dev)
    restored = resumed.train()
    resume_equal = (all(torch.equal(a, b) for a, b in zip(
        checkpoint.state_leaves(restored), saved["leaves"]))
        and resumed._key_cap == saved["key_cap"])
    mh.dist.barrier()  # every rank has read it
    for t in (trainer, resumed):
        if t.writer is not None:  # before the rank exits (its queue)
            t.writer.close()
    # the wrappers refer to the trainer: drop them, so that nothing but
    # this frame holds it and its windows
    for name in ("_get_step", "_maybe_rebucket_key_cap", "_validate"):
        delattr(trainer, name)
    return {"ms_per_iteration": loop_ms, "digest": digest, "finite": finite,
            "modes": modes, "windows": windows, "window_ms": window_ms,
            "refits": refits,
            "captures": sum(r["captured"] for r in windows),
            "saved_iteration": saved["iteration"],
            "resume_equal": resume_equal}


def loop_main(points: int, width: int, height: int, device: str,
              stack_dump_s: float, log_root: str) -> dict:
    from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    STACK_DUMP_S[0] = stack_dump_s
    stage("start")
    if device == "cuda":
        R.pin_f32_matmul()
    dev = mh.rank_device(device)
    xyz, feats = cs.truck_scene_surround(points)
    views = cs.loop_views(camera_K(width, height), dev, points=points,
                          width=width, height=height)
    res = {"rank": mh.rank(), "world": mh.world_size(),
           "backend": mh.dist.get_backend(), "device": str(dev)}
    for name, force in LOOP_RUNS:
        res[name] = trainer_loop(views, xyz, feats, dev,
                                 str(Path(log_root) / name), force)
        stage("loop", name, res[name]["ms_per_iteration"], "ms an iteration")
    res["tracked_windows"] = len(mh.live_windows())
    stage("leaving the process group")
    return res


def write_app_run(root: Path, ranks: int, points: int, width: int,
                  height: int, device: str) -> Path:
    """The loop's views as PNGs with a train/val .json each, the phase-4
    scene as .parquet, and a .json config of phase 14d's schedule with
    ``data_parallel_devices`` ``ranks`` and ``steps_per_dispatch`` 8."""
    from PIL import Image

    from taichi_3d_gaussian_splatting_tpu_torch.models import scene as scene_lib

    K_np = camera_K(width, height)
    views = cs.loop_views(K_np, device, points=points, width=width,
                          height=height)
    T = cs.poses(len(views))
    records = []
    for i, item in enumerate(views):
        path = root / f"view_{i}.png"
        Image.fromarray(np.rint(item.image * 255.0).astype(np.uint8)).save(
            path)
        records.append({"image_path": str(path),
                        "T_pointcloud_camera": T[i].tolist(),
                        "camera_intrinsics": K_np.tolist(),
                        "camera_height": height, "camera_width": width,
                        "camera_id": 0})
    (root / "train.json").write_text(json.dumps(records[:6]))
    (root / "val.json").write_text(json.dumps(records[6:]))
    xyz, feats = cs.truck_scene_surround(points)
    scene_lib.to_parquet(scene_lib.create_scene(
        xyz, scene_lib.SceneConfig(), features=feats, device="cpu"),
        str(root / "scene.parquet"))
    cfg = root / "train_config.json"
    cfg.write_text(json.dumps(cs.loop_config_dict(
        str(root / "logs"), train_dataset_json_path=str(root / "train.json"),
        val_dataset_json_path=str(root / "val.json"),
        pointcloud_parquet_path=str(root / "scene.parquet"),
        steps_per_dispatch=WINDOW, data_parallel_devices=ranks), indent=1))
    return cfg


def run_app(args) -> dict:
    root = Path(tempfile.mkdtemp(prefix="dp_window_app_"))
    try:
        cfg = write_app_run(root, args.ranks, args.points, args.width,
                            args.height, args.device)
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m",
             "taichi_3d_gaussian_splatting_tpu_torch.apps.train",
             "--train_config", str(cfg), "--device", args.device],
            cwd=str(HERE.parent), capture_output=True, text=True,
            timeout=args.app_timeout_s)
        seconds = time.perf_counter() - t0
        out = (r.stdout + r.stderr).splitlines()
        print("\n".join(out[-40:]), flush=True)
        logs = root / "logs"
        res = {"returncode": r.returncode, "seconds": seconds,
               "checkpoint": (logs / "checkpoint_latest").is_dir(),
               "scene_20": (logs / "scene_20.parquet").is_file(),
               "key_cap_lines": [x for x in out if x.startswith("key_cap")]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res["ok"] = res["returncode"] == 0 and res["checkpoint"] and res[
        "scene_20"]
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
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--eager", action="store_true",
                      help="run the window's steps in a loop, whatever "
                      "window_mode gives (the comparison)")
    mode.add_argument("--loop", action="store_true",
                      help="the trainer's loop, windows and forced eager")
    mode.add_argument("--app", action="store_true",
                      help="apps.train on a data-parallel config")
    mode.add_argument("--keep_graph", action="store_true",
                      help="probe: keep the graph past the teardown")
    ap.add_argument("--hang_s", type=float, default=90.0,
                    help="--keep_graph: the ranks are stopped this many s "
                    "+ 60 after the start")
    ap.add_argument("--app_timeout_s", type=float, default=600.0)
    ap.add_argument("--timeout_s", type=float, default=900.0,
                    help="the ranks are stopped after this many s")
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
        cuda_build.build_all()
    cards = card_lines(args.device)
    print(*cards, sep="\n", flush=True)
    t0 = time.perf_counter()
    on_card = args.device == "cuda"
    summary = {"cards": cards}
    if args.app:
        res = run_app(args)
        print(json.dumps(res), flush=True)
        ok = res["ok"]
    elif args.loop:
        with tempfile.TemporaryDirectory(prefix="dp_window_loop_") as logs:
            res = mh.run_local_ranks(loop_main, args.ranks, args=(
                args.points, args.width, args.height, args.device,
                args.stack_dump_s, logs), device=args.device,
                timeout_s=args.timeout_s)
        for r in res:
            print(json.dumps(r), flush=True)
        a = res[0]
        names = [name for name, _ in LOOP_RUNS]
        summary.update({
            name: {"ms_per_iteration": [r[name]["ms_per_iteration"]
                                        for r in res],
                   "window_ms": a[name]["window_ms"],
                   "captures": a[name]["captures"],
                   "windows": len(a[name]["windows"]),
                   "refits": a[name]["refits"]}
            for name in names})
        ok = all(
            len({r[n]["digest"] for n in names} | {a["windows"]["digest"]})
            == 1
            and all(r[n]["finite"] and r[n]["resume_equal"]
                    and r[n]["windows"] == a[n]["windows"]
                    and r[n]["refits"] == a[n]["refits"]
                    for n in names)
            for r in res)
        e = a["eager"]
        for name, force in LOOP_RUNS:
            w = a[name]
            keys = {(tuple(x["size"]), x["sh_band"], x["key_cap"])
                    for x in w["windows"]}
            graph = on_card and not force
            ok = ok and (
                len(w["windows"]) >= 2 and w["refits"]
                and w["refits"] == e["refits"]
                and [x["size"] for x in w["windows"]] == [
                    x["size"] for x in e["windows"]]
                and set(w["modes"]) == {"graph" if graph else "eager"}
                and w["captures"] == (len(keys) if graph else 0)
                and all(x["graphs_held"] == int(graph)
                        for x in w["windows"]))
    else:
        res = mh.run_local_ranks(rank_main, args.ranks, args=(
            args.points, args.width, args.height, args.device,
            args.stack_dump_s, args.eager, args.keep_graph),
            device=args.device,
            timeout_s=args.hang_s + 60 if args.keep_graph else args.timeout_s)
        for r in res:
            print(json.dumps(r), flush=True)
        graph = on_card and not args.eager
        summary.update({
            "mode": [r["mode"] for r in res],
            "window_ms_per_step": [r["window_ms_per_step"] for r in res],
            "eager_ms_per_step": [r["eager_ms_per_step"] for r in res],
            "capture_s": [r["capture_s"] for r in res]})
        ok = (len({r["digest"] for r in res}) == 1
              and all(all(r["window_equals_eager_steps"]) for r in res)
              and all(r["mode"] == ("graph" if graph else "eager")
                      and r["captures"] == int(graph)
                      and r["tracked_windows"] == int(graph) for r in res))
    summary.update(ok=bool(ok), seconds=time.perf_counter() - t0)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
