"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration (``configs/``) and a
traffic mix (``traffic/``). The run makes its inputs from the seed, sets
the program up (``setup_s``: from the start of this script to the first
timed step or frame, kernel builds and graph captures included, less the
seconds the plain reference takes to render the training targets), measures
for ``--seconds``, then frees the program's state and compares what the
window produced with the plain reference (``reference/``) against the
cell's limits (``limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read by
``metrics/<metric>.py`` from a profiler session over the window),
``device`` and, traced, ``breakdown``; ``checks`` comes last: each number
compared, with its limit (also the last lines of standard error).

A cell of several chips runs on as many ranks, one process a card in the
port's process group (``ranks.py``); ``device.count`` is the cell's chips,
``memory_peak_bytes`` the fullest card's, the traced metrics rank 0's.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits with 2. It exits with 3 if ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed, in this
process or on any rank, and with 4 if a rank fails or the ranks are not
done by their deadline.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import cells, drive, ranks, trace  # noqa: E402
from perfbench.ranks import forbidden_modules  # noqa: E402

IMPORTED = time.time()


@dataclass
class Reading:
    """What a per-layer metric reader reads (``metrics/<metric>.py``)."""

    kind: str              # cell driver's ``reads_as``: "train" or "render"
    units: int             # steps or frames in the traced window
    trace: object          # trace.Window, or None without a card
    parts: dict            # cell driver's ``work_parts``: of one unit
    stages: dict           # device ms a frame by gs.* stage (render)


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float = T0, fault=None) -> dict:
    """One run of ``cell``: the result object (``checks`` last). A cell of
    several chips runs on as many ranks (``ranks.py``). ``fault``: a
    context manager factory planted around the program on every rank
    (``calibrate.FAULTS``)."""
    dev = torch.device(device)
    phases = {"imports": IMPORTED - t0}
    t = time.time()
    if dev.type == "cuda":
        from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    phases["kernels built or loaded"] = time.time() - t
    if cell.chips > 1:
        outcome = ranks.run_jobs(cell, [ranks.Job(seed, fault)], seconds,
                                 traced, device, t0)[0]
        phases.update(outcome.phases)
        print("setup phases, s (rank 0): " + ", ".join(
            f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
        found = outcome.forbidden + forbidden_modules()
        if found:
            raise ForbiddenImport(found)
    else:
        with fault() if fault else contextlib.nullcontext():
            outcome = one_rank(cell, seed, seconds, traced, dev, t0, phases)
    return result(cell, outcome, traced, dev)


def one_rank(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             dev: torch.device, t0: float, phases: dict) -> ranks.Outcome:
    """The cell's driver in this process alone."""
    cuda = dev.type == "cuda"
    driver = drive.driver_class(cell.kind)(cell, seed, dev)
    driver.setup()
    # the plain reference's seconds making the inputs are not the program's
    setup_s = time.time() - t0 - driver.reference_s
    phases.update(driver.phases)
    print("setup phases, s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
    window = None
    if traced and cuda:
        with trace.profiled() as held:
            win = driver.window(seconds)
        window = trace.read_window(held.prof, win.wall_s)
    else:
        win = driver.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    stages = driver.stage_frames() if traced and cuda else None
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return ranks.Outcome(driver, win, window, setup_s, dict(driver.phases),
                         memory_peak, stages, driver.check())


def result(cell: cells.Cell, o: ranks.Outcome, traced: bool,
           dev: torch.device) -> dict:
    """The result object of a run's ``Outcome``: the checks, the metrics,
    the device."""
    cuda = dev.type == "cuda"
    driver, win, window = o.driver, o.win, o.window
    metrics = {}
    if not cuda:
        pass  # a CPU run reports no metric: its times are not the card's
    elif traced:
        reading = Reading(driver.reads_as, win.attempted, window,
                          driver.work_parts(), o.stages or {})
        for m in cell.per_layer:
            value = cells.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = {"setup_s": o.setup_s,
                    "step_ms": win.wall_s * 1e3 / win.attempted,
                    "frame_ms": win.wall_s * 1e3 / win.attempted}
        if win.latencies_ms:
            measured["frame_p95_ms"] = float(
                np.percentile(win.latencies_ms, 95))
        for m in cell.end_to_end:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits.get(k)}
              for k, v in o.numbers.items()}
    correct = all(c["limit"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": correct, "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics}
    result["device"] = ({
        "platform": "gpu", "kind": torch.cuda.get_device_name(dev),
        "count": cell.chips, "memory_peak_bytes": int(o.memory_peak),
        "power": power_limit()} if cuda else {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0})
    if window is not None:
        result["device"].update(busy_s=window.busy_s,
                                window_s=window.window_s)
        result["breakdown"] = window.breakdown()
    result["checks"] = checks
    return result


class ForbiddenImport(RuntimeError):
    pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is "
              "False); the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except ForbiddenImport as e:
        print(f"perfbench: modules of JAX or of the JAX package loaded: "
              f"{e.args[0]}", file=sys.stderr)
        return 3
    except ranks.RankFailed as e:
        print(f"perfbench: a rank failed: {e}", file=sys.stderr)
        return ranks.FAILED_EXIT
    if forbidden_modules():
        print(f"perfbench: modules of JAX or of the JAX package loaded: "
              f"{forbidden_modules()}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
