"""Device-side readings of a traced window and of eager frames, from
``torch.profiler``'s events held in memory (no trace file is written).

- ``Window``: the device's busy seconds (the union of every kernel, copy
  and set on the card), device seconds by operation name, the idle gaps
  labelled by what the host was doing (the innermost host range or
  operation open at the gap's middle), and the seconds of kernels whose
  names hold a given string.
- ``stage_ms``: device ms by the innermost ``gs.*`` range of the program
  around each launch, the arithmetic of the port's
  ``tools/profile_attribution.py`` (``_stage_of``, ``analyze``), read from
  events instead of a chrome trace.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
from dataclasses import dataclass, field

import torch

# gaps shorter than this are counted as idle but not labelled
LABEL_GAP_NS = 20_000


def _is_device(e) -> bool:
    """A kernel, copy or set on the card (not a device-side range)."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation())


def _is_launch(e) -> bool:
    """A host call of the CUDA runtime or driver (its correlation id is
    that of the device operations it started)."""
    return (e.device_type() == torch.autograd.DeviceType.CPU
            and e.name().startswith("cu"))


def _events(prof):
    return prof.profiler.kineto_results.events()


@dataclass
class Window:
    window_s: float
    busy_s: float
    device_s: dict = field(default_factory=dict)   # name -> seconds
    idle_by_host: dict = field(default_factory=dict)  # label -> seconds

    def kernel_s(self, part: str) -> float:
        """Seconds of the device operations whose names hold ``part``."""
        return sum(s for n, s in self.device_s.items() if part in n)

    def breakdown(self, top: int = 10) -> dict:
        def rows(d):
            return [[n[:120], s] for n, s in sorted(
                d.items(), key=lambda r: -r[1])[:top]]
        return {"device_ops": rows(self.device_s),
                "idle_gaps": rows(self.idle_by_host)}


def _host_index(events):
    """The host ranges and operations of the thread that launched the
    most work, sorted by start: (starts, [(start, end, name)])."""
    by_thread = collections.defaultdict(list)
    for e in events:
        if (e.device_type() != torch.autograd.DeviceType.CPU
                or e.duration_ns() <= 0):
            continue
        s = e.start_ns()
        by_thread[e.start_thread_id()].append((s, s + e.duration_ns(),
                                               e.name()))
    if not by_thread:
        return [], []
    rows = max(by_thread.values(), key=len)
    rows.sort()
    return [r[0] for r in rows], rows


def _host_label(t: int, starts, rows, reach: int = 4000) -> str:
    """The innermost host range open at time t (the latest-starting one
    that contains it), or "(no host range)"."""
    i = bisect.bisect_right(starts, t) - 1
    lo = max(-1, i - reach)
    while i > lo:
        s, e, name = rows[i]
        if e >= t:
            return name
        i -= 1
    return "(no host range)"


def read_window(prof, window_s: float) -> Window:
    """The ``Window`` of a profiler session over a traced window of
    ``window_s`` host seconds."""
    events = _events(prof)
    spans, by_name = [], collections.Counter()
    for e in events:
        if not _is_device(e) or e.duration_ns() <= 0:
            continue
        s = e.start_ns()
        spans.append((s, s + e.duration_ns()))
        by_name[e.name()] += e.duration_ns() / 1e9
    spans.sort()
    busy, gaps, end = 0, [], None
    for s, e in spans:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    starts, rows = _host_index(events)
    idle = collections.Counter()
    for a, b in gaps:
        if b - a >= LABEL_GAP_NS:
            idle[_host_label((a + b) // 2, starts, rows)] += (b - a) / 1e9
        else:
            idle["(gaps under 20 us)"] += (b - a) / 1e9
    return Window(window_s=window_s, busy_s=busy / 1e9,
                  device_s=dict(by_name), idle_by_host=dict(idle))


@contextlib.contextmanager
def profiled():
    """A profiler session (host and device) around the body; yields a
    holder whose ``prof`` is set."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Held", (), {})()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        holder.prof = prof
        yield holder
        torch.cuda.synchronize()


def stage_ms(prof, runs: int) -> dict:
    """Device ms a run by the innermost ``gs.*`` range around each
    launch (``(unmarked)`` outside them)."""
    events = _events(prof)
    ranges = collections.defaultdict(list)
    launches = {}
    for e in events:
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        if e.name().startswith("gs."):
            ranges[e.start_thread_id()].append(e)
        elif _is_launch(e):
            launches[e.correlation_id()] = e
    out = collections.Counter()
    for e in events:
        if not _is_device(e) or e.duration_ns() <= 0:
            continue
        launch = launches.get(e.correlation_id())
        stage = "(unmarked)"
        if launch is not None:
            t = launch.start_ns()
            best = None
            for r in ranges.get(launch.start_thread_id(), ()):
                if (r.start_ns() <= t <= r.start_ns() + r.duration_ns()
                        and (best is None
                             or r.duration_ns() < best.duration_ns())):
                    best = r
            if best is not None:
                stage = best.name()
        out[stage] += e.duration_ns() / 1e6 / runs
    return dict(out)
