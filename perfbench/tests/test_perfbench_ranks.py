"""A cell on several ranks (``ranks.py``) on the CPU: two gloo ranks of
the data-parallel cell at a tiny size, a rank left out of the gradients'
sum, a rank that raises, a rank that loads JAX; the cell drivers found by
file; and the collective readers' cases with nothing to read."""
import contextlib
import sys
import time
import types

import pytest

from conftest import tiny_cell
from perfbench import calibrate, cells, drive, ranks, run, work
from perfbench.run import Reading

DP = "truck-428k.train-dp4"


@contextlib.contextmanager
def last_rank_raises():
    """The set-up of the last rank raises."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    whole = drive.TrainDriver.scene

    def scene(self):
        if mh.world_size() > 1 and mh.rank() == mh.world_size() - 1:
            raise RuntimeError("a rank that fails")
        return whole(self)
    drive.TrainDriver.scene = scene
    try:
        yield
    finally:
        drive.TrainDriver.scene = whole


@contextlib.contextmanager
def last_rank_loads_jax():
    """A module named ``jax`` in the last rank's ``sys.modules``, left
    there after the window."""
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if mh.world_size() > 1 and mh.rank() == mh.world_size() - 1:
        sys.modules["jax"] = types.ModuleType("jax")
    yield


def test_two_ranks_agree_and_pass_every_limit():
    res = run.run_cell(tiny_cell(DP), 2 ** 31 + 17, 0.3, False,
                       device="cpu")
    checks = res["checks"]
    assert checks["rank_gap"]["value"] == 0.0
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap",
                           "image_gap", "rank_gap"}
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    assert res["correct"] and res["attempted"] % 8 == 0


def test_a_rank_left_out_of_the_sum_fails_rank_gap_and_grad_gap():
    res = run.run_cell(tiny_cell(DP), 2 ** 31 + 17, 0.3, False,
                       device="cpu", fault=calibrate.rank_left_out)
    checks = res["checks"]
    assert checks["rank_gap"]["value"] > 0.0
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    assert not res["correct"]


def test_a_rank_that_raises_ends_the_run():
    t = time.monotonic()
    with pytest.raises(ranks.RankFailed):
        ranks.run_jobs(tiny_cell(DP), [ranks.Job(2 ** 31 + 17,
                                                 last_rank_raises)],
                       0.3, False, "cpu")
    assert time.monotonic() - t < 60.0


def test_jax_loaded_on_another_rank_ends_the_run():
    assert "jax" not in sys.modules
    with pytest.raises(run.ForbiddenImport) as e:
        run.run_cell(tiny_cell(DP), 2 ** 31 + 17, 0.3, False, device="cpu",
                     fault=last_rank_loads_jax)
    assert e.value.args[0] == ["rank 1: jax"]


def test_a_traffic_kind_brings_its_driver_as_a_file():
    dp = drive.driver_class("train-dp")
    assert dp.__name__ == "Driver" and issubclass(dp, drive.TrainDriver)
    assert dp.reads_as == "train"
    assert drive.driver_class("train") is drive.TrainDriver
    assert drive.driver_class("render") is drive.RenderDriver
    with pytest.raises(ValueError, match="no driver"):
        drive.driver_class("no-such-kind")


class Trace:
    def __init__(self, device_s):
        self.device_s = device_s


def test_the_collective_readers_read_nothing_where_there_is_nothing():
    ms = cells.reader("allreduce_ms.train")
    share = cells.reader("allreduce_roofline.train")
    parts = {"collectives": (work.dp_collective_bytes(1000), 0)}
    nccl = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": 0.003,
            "ncclKernel_AllReduce_RING_LL_Max_f64(x)": 0.001,
            "blend_backward_kernel": 0.5}
    # off the card, another kind, no step, no NCCL kernel, no collectives
    for r in (Reading("train", 8, None, parts, {}),
              Reading("render", 8, Trace(nccl), parts, {}),
              Reading("train", 0, Trace(nccl), parts, {}),
              Reading("train", 8, Trace({"blend_backward_kernel": 0.5}),
                      parts, {})):
        assert ms(r) is None and share(r) is None
    assert share(Reading("train", 8, Trace(nccl), {}, {})) is None
    r = Reading("train", 8, Trace(nccl), parts, {})
    assert ms(r) == pytest.approx(0.5)
    least = work.dp_collective_bytes(1000) / work.NVLINK_BYTES_PER_S
    assert share(r) == pytest.approx(100.0 * least / 0.5e-3)
