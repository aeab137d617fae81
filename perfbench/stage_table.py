"""A cell's traced window by the program's ``gs.*`` stages.

    python3 perfbench/stage_table.py --workload <cell> --seed <n> \\
        --seconds <s>

Sets the cell up as ``run.py`` does, runs its window under the profiler,
and prints one JSON object: the units (steps or frames) of the window;
busy and idle seconds; ``idle_by_host`` (``trace.read_window``'s labels);
``idle_by_stage``, the same idle gaps under the innermost ``gs.*`` range of
the program open at each gap's middle (``idle_by_stage``); the replay
readings of the port's ``ops/stages.read()`` (device ms a unit by stage,
and the units read); and, for a render cell, the eager frames' device ms
by stage that ``attrs_ms.render`` and ``tiling_ms.render`` read. It
writes no metric of ``BENCHMARK.json`` and compares nothing with the
reference. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import cells, drive, trace  # noqa: E402

NO_STAGE = "(no gs range)"
SHORT = "(gaps under 20 us)"


def idle_gaps(events) -> list:
    """The (start, end) ns of each gap between device operations of the
    window, as ``trace.read_window`` finds them."""
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events
                   if trace._is_device(e) and e.duration_ns() > 0)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_stage(events) -> dict:
    """Idle seconds by the innermost ``gs.*`` host range open at each
    gap's middle (``(no gs range)`` outside them); gaps under 20 us as
    ``(gaps under 20 us)``, as ``trace.read_window`` labels them."""
    rows = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in events
                  if e.device_type() == torch.autograd.DeviceType.CPU
                  and e.name().startswith("gs.") and e.duration_ns() > 0)
    starts = [r[0] for r in rows]
    out = collections.Counter()
    for a, b in idle_gaps(events):
        if b - a < trace.LABEL_GAP_NS:
            out[SHORT] += (b - a) / 1e9
            continue
        label = trace._host_label((a + b) // 2, starts, rows)
        out[NO_STAGE if label == "(no host range)" else label] += \
            (b - a) / 1e9
    return dict(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_table: no CUDA card", file=sys.stderr)
        return 2
    from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build, stages

    cell = cells.load(args.workload)
    if cell.chips > 1:
        print("stage_table: runs cells of one chip", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cuda_build.build_all()
    driver = drive.driver_class(cell.kind)(cell, args.seed, dev)
    driver.setup()
    stages.reset()
    with trace.profiled() as held:
        win = driver.window(args.seconds)
    events = trace._events(held.prof)
    window = trace.read_window(held.prof, win.wall_s)
    replayed = stages.read()
    eager = driver.stage_frames()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "units": win.attempted,
        "device": torch.cuda.get_device_name(dev), "window_s": win.wall_s,
        "busy_s": window.busy_s,
        "idle_s": window.window_s - window.busy_s,
        "idle_by_host": window.idle_by_host,
        "idle_by_stage": idle_by_stage(events),
        "replay_units": replayed.units, "replay_ms": replayed.ms,
        "eager_ms": eager}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
