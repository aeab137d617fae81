"""A run with its timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program (``calibrate.FAULTS``;
on every rank of a cell of several chips, where the exchange between the
ranks can also leave one out) on the CPU at a tiny size, against the
cell's own limits."""
import json

import pytest

from conftest import ROOT, tiny_cell
from perfbench import calibrate, run

WORKLOADS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
CASES = [(w["name"], fault) for w in WORKLOADS
         for fault in (("state_unchanged", "half_batch", "answer_altered")
                       if w["traffic"].startswith("train")
                       else ("answer_altered",))
         + (("rank_left_out",) if w["chips"] > 1 else ())]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    res = run.run_cell(tiny_cell(name), 2 ** 31 + 7, 0.2, False,
                       device="cpu", fault=calibrate.FAULTS[fault])
    assert not res["correct"], res["checks"]
