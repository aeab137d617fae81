"""``run.py`` end to end on the CPU at a tiny size: every traffic kind
through the program's plain kernel versions and the reference, and the
command itself, which without a card prints no result."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from conftest import HERE, ROOT, tiny_cell
from perfbench import cells, drive, run

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_cpu_run_is_correct_and_reports_no_device_metric(name, traced):
    res = run.run_cell(tiny_cell(name), 2 ** 31 + 99, 0.3, traced,
                       device="cpu")
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    # a CPU run writes no metric: its times are not the card's
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"] and "breakdown" not in res


def test_the_command_prints_no_result_without_a_card():
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no CUDA card" in r.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    """A directory that holds only BENCHMARK.json and ``paths``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout


def test_every_cell_finds_its_files():
    for name in CELLS:
        cell = cells.load(name)
        assert cell.limits, f"{name} has no limits file"
        assert drive.driver_class(cell.kind).reads_as in ("train", "render")
        for m in cell.per_layer:
            assert callable(cells.reader(m["name"]))


def test_a_train_traffic_is_a_window_of_steps():
    cell = tiny_cell("truck-428k.train-w8-resident")
    cell.traffic = dict(cell.traffic, steps_per_call=1)
    with pytest.raises(ValueError, match="steps_per_call"):
        drive.TrainDriver(cell, 1, "cpu")


def test_setup_s_leaves_out_the_reference_making_the_targets():
    d = drive.TrainDriver(tiny_cell("truck-428k.train-w8-resident"),
                          2 ** 31 + 3, "cpu")
    t = time.perf_counter()
    d.setup()
    assert 0.0 < d.reference_s < time.perf_counter() - t
