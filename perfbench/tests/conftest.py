"""Tests of the benchmark harness. CPU tests run the harness at a tiny
size with the program's plain kernel versions; tests marked ``cuda`` need
the card and skip without one (decided in the ``card`` fixture)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cells  # noqa: E402

HERE = ROOT / "perfbench"


def tiny_cell(name: str, points: int = 400, size: int = 64) -> cells.Cell:
    """The cell ``name`` at a tiny size (``points`` points, size x size
    views, focal 60 px; a cell of several chips on 2 ranks), with its own
    limits: a cell of BENCHMARK.json, or ``<config>.<traffic>`` of the
    files under ``perfbench/``."""
    try:
        cell = cells.load(name)
    except SystemExit:
        config, traffic = name.split(".")
        cell = cells.Cell(
            name, 1, json.loads((HERE / "configs" / f"{config}.json")
                                .read_text()),
            json.loads((HERE / "traffic" / f"{traffic}.json").read_text()),
            json.loads((HERE / "limits" / f"{name}.json").read_text()))
    cell.config = json.loads(json.dumps(cell.config))
    cell.config["points"] = points
    cell.config["views"] = {"width": size, "height": size, "focal_px": 60.0}
    cell.traffic = {k: v for k, v in cell.traffic.items() if k != "views"}
    if cell.chips > 1:
        cell.chips = cell.traffic["ranks"] = 2
    return cell


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
