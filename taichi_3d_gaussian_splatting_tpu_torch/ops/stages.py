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

``count(names, fill, device)`` records counters of the unit under way
(``ops/tiling.py``: the tile counters of each frame's keys) beside the
marks, in a capture opened with ``capturing(counters=True)`` (the
one-card train window's; render graphs and data-parallel windows record
none): ``fill`` writes them into slots of the same buffer on the device,
each replay rewrites them, and a replay that is read adds them to the
readings. Outside a capture they are recorded at once on the CPU (so that
tests read them) and not at all on a card. ``read()`` gives each
counter's mean over the records read, beside ``ms``.
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

    def __init__(self, counters: bool = False):
        self.marks: list = []
        self.counts_on = counters  # whether ``count`` records here
        self.unit = 0        # the unit being captured: a window's step
        self.depth = 0
        self.counted = 0     # the slots the warm-up asked for
        self.used = 0
        self.slots: Optional[torch.Tensor] = None  # (counted,) int64 ns
        self.counters: list = []  # (name, slot) of each counter
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

    def _take(self, n: int) -> int:
        """The first of the next ``n`` slots."""
        i = self.used
        if i + n > self.counted:
            raise RuntimeError(
                f"the capture takes more than the {self.counted} slots of "
                "stage ends and counters its warm-up made")
        self.used += n
        return i

    def _mark(self) -> int:
        i = self._take(1)
        launch = cuda_build.bind("stage_mark", "stage_mark",
                                 [ctypes.c_void_p, ctypes.c_void_p])
        cuda_build.check(launch(self.slots.data_ptr() + 8 * i,
                                cuda_build.stream_of(self.slots)),
                         "stage_mark")
        return i


class Reading(NamedTuple):
    units: int   # steps or frames read
    ms: dict     # stage name -> device ms a unit
    counts: dict = {}  # counter name -> its mean over the records read


_capture: Optional[Record] = None  # the record of the capture under way
_pending: list = []                # records whose last replay is unread
_total_ms: collections.Counter = collections.Counter()
_units = 0
_count_total: collections.Counter = collections.Counter()
_count_records: collections.Counter = collections.Counter()


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
def capturing(counters: bool = False):
    """The record of the warm-up and the capture the body makes
    (``trainer.capture_graph``: the warm-up, ``Record.allocate``, the
    capture); ``counters``: whether ``count`` records in it."""
    global _capture
    _capture = Record(counters)
    try:
        yield _capture
    finally:
        _capture = None


def count(names: tuple, fill, device) -> None:
    """Counters of the unit under way, one int64 a name: ``fill(out)``
    writes them into ``out`` ((len(names),) int64 on ``device``) with no
    host sync. Inside a capture that records counters ``out`` is a run of
    the record's slots (in its warm-up the slots are counted and nothing is
    filled), inside any other nothing runs; outside one the counters are
    recorded at once on the CPU, and on a card nothing runs."""
    rec = _capture
    if rec is None:
        if torch.device(device).type == "cpu":
            out = torch.empty(len(names), dtype=torch.int64)
            fill(out)
            _add_counts(zip(names, out.tolist()))
        return
    if not rec.counts_on:
        return
    if rec.slots is None:  # the warm-up
        rec.counted += len(names)
        return
    i = rec._take(len(names))
    fill(rec.slots[i:i + len(names)])
    rec.counters.extend((name, i + j) for j, name in enumerate(names))


def _add_counts(pairs) -> None:
    for name, value in pairs:
        _count_total[name] += value
        _count_records[name] += 1


def set_unit(unit: int) -> None:
    """The stages that follow belong to unit ``unit`` of the capture under
    way (a window's step); no effect outside a capture."""
    if _capture is not None:
        _capture.unit = unit


def _fold(rec: Record) -> None:
    """Adds the record's last replay to the readings."""
    global _units
    t = rec.slots.tolist()
    _add_counts((name, t[slot]) for name, slot in rec.counters)
    if not rec.marks:
        return
    covered = 0.0
    for m in rec.marks:
        ms = (t[m.end] - t[m.start]) / 1e6
        _total_ms[m.name] += ms
        if m.depth == 0:
            covered += ms
    # the span: the first stage's start to the last outermost end
    first = min(m.start for m in rec.marks)
    last = max(m.end for m in rec.marks)
    _total_ms[UNMARKED] += (t[last] - t[first]) / 1e6 - covered
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
    if (record is not None and (record.marks or record.counters)
            and torch.autograd._profiler_enabled()):
        if record.done is None:
            record.done = torch.cuda.Event()
        record.done.record()
        _pending.append(record)


def read() -> Reading:
    """Device ms a unit by stage name over the replays read since
    ``reset()``, and each counter's mean over its records (``count``);
    synchronises if a replay awaits its reading."""
    if _pending:
        torch.cuda.synchronize()
        _fold_pending()
    counts = {k: v / _count_records[k] for k, v in _count_total.items()}
    if not _units:
        return Reading(0, {}, counts)
    return Reading(_units, {k: v / _units for k, v in _total_ms.items()},
                   counts)


def reset() -> None:
    """Forgets every reading and every replay awaiting one."""
    global _units
    _pending.clear()
    _total_ms.clear()
    _units = 0
    _count_total.clear()
    _count_records.clear()
