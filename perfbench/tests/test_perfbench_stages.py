"""The replay-stage readers (``replay.py``, ``metrics/replay_*.py``) and
``stage_table.idle_by_stage`` on the CPU: the readers return None off the
card and with no reading, and the port's reading where there is one; the
idle gaps by ``gs.*`` range add up to ``trace.read_window``'s."""
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the repo on the path)
from perfbench import cells, stage_table, trace
from perfbench.run import Reading

from taichi_3d_gaussian_splatting_tpu_torch.ops import stages

REPLAY = {"replay_loss_ms.train": ("train", "gs.loss"),
          "replay_blend_backward_ms.train": ("train", "gs.blend_backward"),
          "replay_attributes_vjp_ms.train": ("train", "gs.attributes_vjp"),
          "replay_update_ms.train": ("train", "gs.update"),
          "replay_attributes_ms.render": ("render", "gs.attributes"),
          "replay_tiling_ms.render": ("render", "gs.tiling")}


def _reading(kind, traced=True):
    return Reading(kind, 8, object() if traced else None, {}, {})


def test_replay_readers_read_the_ports_stages(monkeypatch):
    monkeypatch.setattr(stages, "read", lambda: stages.Reading(
        16, {name: float(i + 1) for i, (_, name) in
             enumerate(REPLAY.values())}))
    for i, (metric, (kind, _)) in enumerate(REPLAY.items()):
        read = cells.reader(metric)
        assert read(_reading(kind)) == float(i + 1)
        other = "render" if kind == "train" else "train"
        assert read(_reading(other)) is None
        assert read(_reading(kind, traced=False)) is None


def test_replay_readers_give_none_with_no_reading():
    stages.reset()
    for metric, (kind, _) in REPLAY.items():
        assert cells.reader(metric)(_reading(kind)) is None


class Ev:
    """A kineto event: host (``cpu``) or device."""

    def __init__(self, name, start, dur, cpu=False):
        self._n, self._s, self._d, self._cpu = name, start, dur, cpu

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._cpu
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return False

    def start_thread_id(self):
        return 1


def test_idle_by_stage_labels_the_gaps_read_window_counts(monkeypatch):
    """Gaps of 20 us or more go under the innermost gs.* range open at
    their middle (a host call inside it does not hide it), or under
    ``(no gs range)``; shorter ones under ``(gaps under 20 us)``; the
    total is ``idle_by_host``'s."""
    us = 1000
    events = [
        Ev("k", 0, 100 * us), Ev("k", 150 * us, 100 * us),     # gap 50
        Ev("k", 260 * us, 100 * us),                           # gap 10
        Ev("k", 400 * us, 100 * us),                           # gap 40
        Ev("k", 600 * us, 10 * us),                            # gap 100
        Ev("gs.replay", 90 * us, 80 * us, cpu=True),
        Ev("cudaGraphLaunch", 110 * us, 30 * us, cpu=True),
        Ev("gs.to_frame", 500 * us, 200 * us, cpu=True),
        Ev("cudaMemcpyAsync", 520 * us, 100 * us, cpu=True)]
    monkeypatch.setattr(trace, "_events", lambda prof: events)
    got = stage_table.idle_by_stage(events)
    assert got == {"gs.replay": 50e-6, "(gaps under 20 us)": 10e-6,
                   "(no gs range)": 40e-6, "gs.to_frame": 100e-6}
    window = trace.read_window(None, 1.0)
    assert window.idle_by_host["cudaGraphLaunch"] == 50e-6
    assert sum(got.values()) == pytest.approx(
        sum(window.idle_by_host.values()), rel=1e-12)
