#!/usr/bin/env python3
"""The quality gate's presets on one NVIDIA card (H100), each a run of
``tools/quality_run.py`` in a process of its own, and the default preset
with graph windows against windows forced eager.

    python3 kernel_variants/quality_runs.py --out_dir DIR [default] [long]
        [reference] [ab]

``default``, ``long`` (``--long --iterations 7000``) and ``reference``
(``--reference_regime``) each run the tool's command line into a temporary
directory and write its console output, headed by the command and the
card's ``nvidia-smi`` name and power limit, to
``DIR/logs_quality_run_torch_{default,long,reference_regime}.txt``.
While a run goes, only its newest ``scene_*.parquet`` is kept (the
reference regime exports 30 scenes of ~100 MB). ``ab`` runs the default
preset four times in this process, with graph windows, forced eager (each
window's steps one after another, ``windowed.mode``), eager, graph, and
writes the records to ``DIR/quality_ab.json``. Needs the card; exits 1
without one.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
TOOL = "taichi_3d_gaussian_splatting_tpu_torch.tools.quality_run"
PRESETS = {"default": ("default", []),
           "long": ("long", ["--long", "--iterations", "7000"]),
           "reference": ("reference_regime", ["--reference_regime"])}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def run_preset(out: Path, name: str, flags: list,
               limit_s: float = 3300) -> int:
    """The tool's run of ``flags`` in a subprocess, its output to the log
    in ``out``; stopped after ``limit_s`` seconds."""
    log = out / f"logs_quality_run_torch_{name}.txt"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as d, open(log, "w") as f:
        f.write(f"$ python -m {TOOL} {' '.join(flags)} --out <a temporary "
                f"directory>\n# {card()}\n")
        f.flush()
        p = subprocess.Popen([sys.executable, "-u", "-m", TOOL, *flags,
                              "--out", d], stdout=f,
                             stderr=subprocess.STDOUT, cwd=ROOT)
        while p.poll() is None:
            time.sleep(15)
            scenes = sorted(glob.glob(f"{d}/logs/scene_*.parquet"),
                            key=os.path.getmtime)
            for s in scenes[:-1]:
                os.remove(s)
            if time.time() - t0 > limit_s:
                p.kill()
                p.wait()
                f.write(f"\n# stopped after {limit_s} s\n")
        f.write(f"\n# exit {p.returncode}, {time.time() - t0:.1f} s\n")
    print(log.read_text(), flush=True)
    return p.returncode


def graph_against_eager(out: Path) -> list:
    """The default preset with graph windows and forced eager, in turns."""
    from taichi_3d_gaussian_splatting_tpu_torch.tools import quality_run as qr
    from taichi_3d_gaussian_splatting_tpu_torch.training import trainer

    class EagerWindows(trainer.GaussianPointCloudTrainer):
        def _get_step(self, h, w, scan_steps=0):
            fn = super()._get_step(h, w, scan_steps)
            if scan_steps:
                fn.mode = "eager"
            return fn

    rows = []
    for mode in ("graph", "eager", "eager", "graph"):
        with tempfile.TemporaryDirectory() as d:
            rec = qr.main(["--out", d], trainer_class=(
                EagerWindows if mode == "eager" else None))
        rec.pop("state")
        rows.append({"mode": mode, **rec})
        print(f"{mode}: {rec['seconds']:.2f} s, {rec['it_per_s']:.2f} it/s, "
              f"best {rec['best_val_psnr']:.3f}, captures {rec['captures']}"
              f", replays {rec['replays']}", flush=True)
    (out / "quality_ab.json").write_text(json.dumps(
        {"card": card(), "rows": rows}, default=str, indent=1))
    return rows


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out_dir", required=True, type=Path)
    ap.add_argument("runs", nargs="+", choices=[*PRESETS, "ab"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quality_runs: no CUDA card", file=sys.stderr)
        return 1
    args.out_dir.mkdir(parents=True, exist_ok=True)
    print(card(), flush=True)
    rc = 0
    for what in args.runs:
        if what == "ab":
            graph_against_eager(args.out_dir)
        else:
            rc |= run_preset(args.out_dir, *PRESETS[what])
    return rc


if __name__ == "__main__":
    sys.exit(main())
