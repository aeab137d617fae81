"""What a cell is made of, found by name in ``BENCHMARK.json``: its
configuration file, its traffic mix (``traffic/<mix>.json``), its limits
(``limits/<cell>.json``), the end-to-end metrics it reports and the
per-layer metrics whose readers (``metrics/<metric>.py``) it runs."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def views(self) -> dict:
        """The view geometry: the configuration's, unless the traffic mix
        brings its own."""
        return self.traffic.get("views", self.config["views"])


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` runs in those cells; one without, in
    every cell that reports the end-to-end metric it ``moves`` (an
    end-to-end metric: in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_file = HERE / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text()) if limits_file.exists()
              else {})
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
