"""A cell on several ranks: ``cell.chips`` processes, one a card, in one
process group of the port (``parallel/multihost.py``: joined by
``initialize``, left by ``shutdown``, which releases every captured
window first).

The process that calls ``run_jobs`` is rank 0 on ``cuda:0`` (the CPU:
gloo); it spawns ranks 1 to n-1 (``spawn`` context), rank r on
``cuda:r``. For each job every rank runs the cell's driver under the
job's planted fault, if any: its set-up; ``WARM_CALLS`` window calls,
which rank 0 times to fix the count of calls for ``seconds`` (broadcast
once, in set-up, so that every rank makes the same calls and nothing in
the window talks to the host); the window, under the profiler on every
rank when traced (only rank 0's trace is read); its memory peak; and
``rank_gap``, the largest |leaf on rank r - leaf on rank 0| over the
ranks and the program's state after the window (bit-identical ranks read
0); and the modules of JAX or of the JAX package in its ``sys.modules``
(``forbidden_modules``). Rank 0 alone then runs the cell driver's
``check``, while the other ranks wait at a barrier; after the last job
the ranks leave the group together. A list of jobs runs in one group
(``calibrate.py``'s seeds and faults): a job there costs its set-up,
window and check, not the ranks' start and join again.

A rank that exits with an error, or a group not done by the deadline,
ends the run: rank 0 stops every rank and raises ``RankFailed``; a rank 0
held in a collective of a dead peer (NCCL inside a CUDA graph waits
without end) ends its process with ``FAILED_EXIT`` ``GRACE_S`` later. A
rank whose rank 0 is gone ends itself.
"""
from __future__ import annotations

import contextlib
import math
import multiprocessing as mp
import os
import queue
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from perfbench import drive, trace

WARM_CALLS = 3
# seconds a job may take on the ranks, from the spawn: set-up, window,
# comparison, and rank 0's check
DEADLINE_S = 300.0
GRACE_S = 30.0
FAILED_EXIT = 4

FORBIDDEN = ("jax", "jaxlib", "flax", "taichi_3d_gaussian_splatting_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class RankFailed(RuntimeError):
    pass


@dataclass
class Job:
    seed: int
    # a context manager factory planted on every rank around the program
    # (``calibrate.FAULTS``); pickled by reference for the spawned ranks
    fault: Optional[Callable] = None


@dataclass
class Outcome:
    """Rank 0's reading of one job."""

    driver: object
    win: drive.Window
    window: object          # trace.Window of rank 0, or None
    setup_s: float
    phases: dict
    memory_peak: int        # the fullest rank's
    stages: Optional[dict]  # the cell driver's ``stage_frames`` when traced
    numbers: dict           # the check's (several ranks: and ``rank_gap``)
    # ``forbidden_modules`` of the other ranks after the window, as
    # "rank r: module"
    forbidden: list = field(default_factory=list)


def _program(cell, job: Job, seconds: float, traced: bool, dev, t0: float,
             rank: int):
    """Every rank's part of a job: (driver, window, trace or None, set-up
    seconds, memory peak, rank_gap on rank 0)."""
    import torch.distributed as dist

    cuda = dev.type == "cuda"
    with job.fault() if job.fault else contextlib.nullcontext():
        driver = drive.driver_class(cell.kind)(cell, job.seed, dev)
        driver.setup()
        warm = driver.window(0.0, calls=WARM_CALLS)
        calls = torch.tensor([max(1, math.ceil(
            seconds * WARM_CALLS / max(warm.wall_s, 1e-9)))],
            dtype=torch.int64, device=dev)
        dist.broadcast(calls, 0)
        calls = int(calls)
        setup_s = time.time() - t0 - driver.reference_s
        window = None
        if traced and cuda:
            with trace.profiled() as held:
                win = driver.window(seconds, calls=calls)
            if rank == 0:
                window = trace.read_window(held.prof, win.wall_s)
        else:
            win = driver.window(seconds, calls=calls)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    gap = rank_gap(driver.state_leaves(), dev)
    return driver, win, window, setup_s, peak, gap


def rank_gap(leaves: list, dev) -> float:
    """The largest |leaf - rank 0's leaf| over ``leaves`` and the ranks
    (inf where either is not finite and they differ), on every rank."""
    import torch.distributed as dist

    gap = torch.zeros((), dtype=torch.float64, device=dev)
    for leaf in leaves:
        mine = leaf.detach().to(torch.float64)
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        if mine.numel():
            d = torch.nan_to_num((mine - theirs).abs(), nan=math.inf)
            gap = torch.maximum(gap, torch.where(mine == theirs, 0.0,
                                                 d).max())
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _join(world: int, rank: int, port: int, device: str):
    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mh.initialize(f"127.0.0.1:{port}", world, rank, local_rank=rank,
                  local_world_size=world, device=device)
    return mh.rank_device(device)


def _orphaned(parent: int) -> None:
    """Ends this rank once the process that started it is gone."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(FAILED_EXIT)


def _rank(rank: int, world: int, port: int, device: str, cell, jobs: list,
          seconds: float, traced: bool, reports, barrier) -> None:
    """Rank ``rank`` (1 to world - 1) in its own process."""
    os.dup2(2, 1)  # standard output is rank 0's: its last line, the result
    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    try:
        from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
            multihost as mh,
        )

        dev = _join(world, rank, port, device)
        driver = None
        for job in jobs:
            driver = None  # the last job's windows go before this set-up
            drive._free(dev)
            driver, _, _, _, peak, _ = _program(cell, job, seconds, traced,
                                                dev, time.time(), rank)
            reports.put((rank, peak, forbidden_modules()))
            barrier.wait()  # rank 0 checks
        mh.shutdown()  # releases the last job's windows
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class _Watch(threading.Thread):
    """Rank 0's watch over the ranks it started: a rank that exits with an
    error, or the deadline, stops them all and breaks the barrier; a rank
    0 that has not returned ``GRACE_S`` later ends its process."""

    def __init__(self, procs: list, barrier, deadline_s: float):
        super().__init__(daemon=True)
        self.procs, self.barrier = procs, barrier
        self.deadline_s = deadline_s
        self.deadline = time.monotonic() + deadline_s
        self.why = None
        self.failed_at = 0.0
        self.done = threading.Event()

    def fail(self, why: str) -> None:
        if self.why is None:
            self.why, self.failed_at = why, time.monotonic()
            print(f"perfbench: {why}; stopping the ranks", file=sys.stderr,
                  flush=True)
            for p in self.procs:
                if p.is_alive():
                    p.kill()
            self.barrier.abort()

    def run(self) -> None:
        while not self.done.wait(0.5):
            if self.why is None:
                dead = [(r, p.exitcode) for r, p in enumerate(self.procs, 1)
                        if p.exitcode not in (None, 0)]
                if dead:
                    self.fail(f"rank {dead[0][0]} exited with "
                              f"{dead[0][1]}")
                elif time.monotonic() > self.deadline:
                    self.fail(f"the ranks were not done within "
                              f"{self.deadline_s:.0f} s")
            elif time.monotonic() - self.failed_at > GRACE_S:
                print(f"perfbench: rank 0 still waiting {GRACE_S:.0f} s "
                      f"after: {self.why}", file=sys.stderr, flush=True)
                os._exit(FAILED_EXIT)

    def stop(self) -> None:
        self.done.set()
        self.join()


def run_jobs(cell, jobs: list, seconds: float, traced: bool,
             device: str = "cuda", t0: Optional[float] = None) -> list:
    """Rank 0's ``Outcome`` of each job, run on ``cell.chips`` ranks in one
    process group. ``t0``: the start that the first job's ``setup_s``
    counts from (later jobs count from their own start). Raises
    ``RankFailed`` when a rank fails or the deadline passes."""
    import torch.distributed as dist

    from taichi_3d_gaussian_splatting_tpu_torch.parallel import (
        multihost as mh,
    )

    if torch.device(device).type == "cuda":  # once, before the ranks load
        from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build

        cuda_build.build_all()
    world = cell.chips
    ctx = mp.get_context("spawn")
    reports, barrier = ctx.Queue(), ctx.Barrier(world)
    port = mh.free_port()
    procs = [ctx.Process(target=_rank, args=(
        r, world, port, device, cell, jobs, seconds, traced, reports,
        barrier), daemon=True) for r in range(1, world)]
    for p in procs:
        p.start()
    watch = _Watch(procs, barrier, DEADLINE_S * len(jobs))
    watch.start()
    local_rank = os.environ.get("LOCAL_RANK")
    out = []
    try:
        t = time.time()
        dev = _join(world, 0, port, device)
        joined = {"ranks started and joined": time.time() - t}
        for i, job in enumerate(jobs):
            start = t0 if i == 0 and t0 is not None else time.time()
            driver, win, window, setup_s, peak, gap = _program(
                cell, job, seconds, traced, dev, start, 0)
            peaks, found = [peak], []
            while len(peaks) < world:
                if watch.why:
                    raise RankFailed(watch.why)
                with contextlib.suppress(queue.Empty):
                    r, p, names = reports.get(timeout=1.0)
                    peaks.append(p)
                    found += [f"rank {r}: {m}" for m in names]
            stages = (driver.stage_frames() if traced and dev.type == "cuda"
                      else None)
            numbers = driver.check()
            numbers["rank_gap"] = gap
            out.append(Outcome(driver, win, window, setup_s,
                               dict(joined if i == 0 else {},
                                    **driver.phases), max(peaks), stages,
                               numbers, sorted(found)))
            barrier.wait()
        mh.shutdown()
        for p in procs:
            p.join(timeout=max(watch.deadline - time.monotonic(), 1.0))
        if any(p.exitcode != 0 for p in procs):
            raise RankFailed(watch.why or "ranks exited with "
                             f"{[p.exitcode for p in procs]}")
    except BaseException as e:
        peer = watch.why  # a rank's failure, seen before rank 0's
        watch.fail(f"rank 0: {type(e).__name__}: {e}")
        if dist.is_initialized():  # the watch ends a teardown that hangs
            dist.destroy_process_group()
        if isinstance(e, RankFailed) or not isinstance(e, Exception):
            raise
        raise RankFailed(f"{peer or 'rank 0 failed'}: "
                         f"{type(e).__name__}: {e}") from e
    finally:
        watch.stop()
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if local_rank is None:
            os.environ.pop("LOCAL_RANK", None)
        else:
            os.environ["LOCAL_RANK"] = local_rank
    return out
