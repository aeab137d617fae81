"""On the card, at each cell's own size: the control (the plain reference
in the program's place, computed in TF32) fails the cell's limits on three
seeds, and a short run of the program's timed path passes them.

    python -m pytest perfbench/tests -m cuda
"""
import json

import pytest

from conftest import ROOT
from perfbench import calibrate, cells

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]


# numbers that the control, the reference on one card, cannot give
NOT_THE_CONTROLS = {"rank_gap"}


def over(numbers: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(card, name):
    cell = cells.load(name)
    limits = {k: v for k, v in cell.limits.items()
              if k not in NOT_THE_CONTROLS}
    for seed in SEEDS:
        got = calibrate.control_numbers(cell, seed, card)["numbers"]
        assert over(got, limits), (seed, got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_is_correct(card, name):
    import torch

    cell = cells.load(name)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} visible")
    got = calibrate.program_numbers(cell, SEEDS[0], 0.5, card)["numbers"]
    assert not over(got, cell.limits), got
