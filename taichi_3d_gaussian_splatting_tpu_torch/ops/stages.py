"""The program's stages: ``gs.*`` ranges that also time a CUDA graph's
replays.

``stage(name)`` opens ``torch.profiler.record_function(name)``, the range
``torch.profiler`` shows while Python runs the stage. A graph replay runs
none of that Python, so inside a capture (``trainer.capture_graph`` opens
``capturing()`` around its warm-up and its capture) a stage also marks
its start and its end on the device: ``csrc/stage_mark.cu``, a one-thread
kernel node that stores the device's nanosecond clock into a slot of the
record's buffer. The warm-up counts the slots, and the buffer is made
before the capture. The capture's ``Record`` lists the stages in the
order they closed, each with its unit: the step of a training window
(``set_unit``), or the one frame of a render graph. Outside a capture a
stage is the profiler range alone: no mark, no CUDA call.

``replay(graph, record)`` replays a graph. A replay made while a
``torch.profiler`` session is active is read: its slots are read at the
next replay call, if the replay has completed by then (else the next
replay overwrites them and that replay goes unread), or by ``read()``,
which synchronises first. With no profiler nothing is read and no host
work is added; the graph's mark nodes are the only cost. ``read()``
returns the device ms a unit (a step or a frame) by stage name over every
unit read since ``reset()``, with ``(unmarked)`` the rest of each
replay's span, from its first mark to its last, that no outermost stage
covers. Readings outlive the graphs: a record that awaits its reading is
held here until it is read.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

UNMARKED = "(unmarked)"


class Mark(NamedTuple):
    unit: int
    name: str
    depth: int    # 0: no stage of the record around it
    start: int    # slots of the record's buffer
    end: int


class Record:
    """The stages of one captured graph, in the order they closed."""

    def __init__(self):
        self.marks: list = []
        self.unit = 0        # the unit being captured: a window's step
        self.depth = 0
        self.counted = 0     # the slots the warm-up asked for
        self.used = 0
        self.slots: Optional[torch.Tensor] = None  # (counted,) int64 ns
        self.done = None     # an event after the last replay made

    @property
    def units(self) -> int:
        return self.unit + 1

    def allocate(self, dev: torch.device) -> None:
        """The buffer for the slots the warm-up counted (before the
        capture); the unit count starts again."""
        self.unit = 0
        if self.counted:
            self.slots = torch.zeros(self.counted, dtype=torch.int64,
                                     device=dev)

    def _mark(self) -> int:
        i = self.used
        if i >= self.counted:
            raise RuntimeError(
                f"the capture marks more than the {self.counted} stage "
                "ends its warm-up made")
        launch = cuda_build.bind("stage_mark", "stage_mark",
                                 [ctypes.c_void_p, ctypes.c_void_p])
        cuda_build.check(launch(self.slots.data_ptr() + 8 * i,
                                cuda_build.stream_of(self.slots)),
                         "stage_mark")
        self.used += 1
        return i


class Reading(NamedTuple):
    units: int   # steps or frames read
    ms: dict     # stage name -> device ms a unit


_capture: Optional[Record] = None  # the record of the capture under way
_pending: list = []                # records whose last replay is unread
_total_ms: collections.Counter = collections.Counter()
_units = 0


@contextlib.contextmanager
def stage(name: str):
    """The profiler range ``name``; inside a capture, also the stage's
    start and end marks in the capture's record (in its warm-up, their
    count)."""
    rec = _capture
    with record_function(name):
        if rec is None:
            yield
            return
        if rec.slots is None:  # the warm-up
            rec.counted += 2
            yield
            return
        start = rec._mark()
        depth = rec.depth
        rec.depth += 1
        try:
            yield
        finally:
            rec.depth -= 1
            rec.marks.append(Mark(rec.unit, name, depth, start,
                                  rec._mark()))


@contextlib.contextmanager
def capturing():
    """The record of the warm-up and the capture the body makes
    (``trainer.capture_graph``: the warm-up, ``Record.allocate``, the
    capture)."""
    global _capture
    _capture = Record()
    try:
        yield _capture
    finally:
        _capture = None


def set_unit(unit: int) -> None:
    """The stages that follow belong to unit ``unit`` of the capture under
    way (a window's step); no effect outside a capture."""
    if _capture is not None:
        _capture.unit = unit


def _fold(rec: Record) -> None:
    """Adds the record's last replay to the readings."""
    global _units
    t = rec.slots.tolist()
    covered = 0.0
    for m in rec.marks:
        ms = (t[m.end] - t[m.start]) / 1e6
        _total_ms[m.name] += ms
        if m.depth == 0:
            covered += ms
    # the first slot is the first stage's start, the last its outermost end
    _total_ms[UNMARKED] += (t[rec.used - 1] - t[0]) / 1e6 - covered
    _units += rec.units


def _fold_pending(replaying: Optional[Record] = None) -> None:
    """Reads each pending record whose last replay has completed; a pending
    record about to replay again before it completed goes unread."""
    keep = []
    for rec in _pending:
        if rec.done.query():
            _fold(rec)
        elif rec is not replaying:
            keep.append(rec)
    _pending[:] = keep


def replay(graph, record: Optional[Record]) -> None:
    """``graph.replay()``; read under a profiler (module docstring)."""
    if _pending:
        _fold_pending(record)
    graph.replay()
    if (record is not None and record.marks
            and torch.autograd._profiler_enabled()):
        if record.done is None:
            record.done = torch.cuda.Event()
        record.done.record()
        _pending.append(record)


def read() -> Reading:
    """Device ms a unit by stage name over the replays read since
    ``reset()``; synchronises if a replay awaits its reading."""
    if _pending:
        torch.cuda.synchronize()
        _fold_pending()
    if not _units:
        return Reading(0, {})
    return Reading(_units, {k: v / _units for k, v in _total_ms.items()})


def reset() -> None:
    """Forgets every reading and every replay awaiting one."""
    global _units
    _pending.clear()
    _total_ms.clear()
    _units = 0
