"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program (``calibrate.FAULTS``)
on the CPU at a tiny size, against the cell's own limits."""
import json

import pytest

from conftest import ROOT, tiny_cell
from perfbench import calibrate, run

CELLS = {w["name"]: w["traffic"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]}
CASES = [(name, fault) for name, traffic in CELLS.items()
         for fault in (("state_unchanged", "half_batch", "answer_altered")
                       if traffic.startswith("train")
                       else ("answer_altered",))]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    with calibrate.FAULTS[fault]():
        res = run.run_cell(tiny_cell(name), 2 ** 31 + 7, 0.2, False,
                           device="cpu")
    assert not res["correct"], res["checks"]
