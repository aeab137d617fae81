"""Multi-process training and rendering over ``torch.distributed``.

Port of ``taichi_3d_gaussian_splatting_tpu/parallel/multihost.py``. The
JAX package drives a device mesh from one process per host; here every
device is a rank of its own process (the PyTorch idiom), so a mesh of N
devices is a process group of N ranks:

- ``initialize`` joins (or forms) the group: from an explicit coordinator
  address, process count and id, or from the environment ``torchrun``
  sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``). It is idempotent, its timeout is explicit (a lost peer
  fails the run instead of blocking it), and a world size other than the
  one asked for raises;
- ``run_local_ranks`` spawns N local ranks of one function (``apps/train.py``
  and ``apps/render.py`` use it when no group is given);
- rank r drives ``cuda:{local_rank % device_count}``, or the CPU when the
  caller asks for it; ``choose_backend`` is the one place that picks the
  backend: NCCL where each local rank has a card of its own, gloo on the
  CPU and where ranks share a card (NCCL refuses two ranks of one
  communicator on one device);
- every collective of the port is ``all_reduce`` (SUM, MAX) or
  ``broadcast`` (``all_reduce_packed``, ``broadcast_tree``): gloo takes
  CUDA tensors for those alone. Without a process group they act as a
  group of one, so the parallel steps also run in a single process;
- per-rank data loading: every rank draws the SAME deterministic global
  camera-index stream (``GlobalShuffleSampler``, the JAX stream for the
  same seed) and decodes only its own rows (``local_slice``,
  ``ThreadedIndexLoader``); the state is replicated by a broadcast from
  rank 0 (``broadcast_tree``), where the JAX package assembles global
  arrays;
- ``shutdown`` is the one way out of the group: it first releases every
  captured window of steps still alive (``track_window``), whose CUDA graph
  holds the group's collectives, then syncs the card, meets the other ranks
  at a barrier and destroys the group.
"""
from __future__ import annotations

import datetime
import os
import socket
import traceback
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from taichi_3d_gaussian_splatting_tpu_torch.data.dataset import (
    MAX_RESOLUTION_TRAIN,
)

# a collective or a rendezvous that waits longer than this fails the run
DEFAULT_TIMEOUT_S = 120.0


def choose_backend(device_type: str, local_world_size: int,
                   cuda_count: int) -> str:
    """The process-group backend: ``nccl`` where every local rank has a
    card of its own, ``gloo`` on the CPU and where ranks share a card."""
    if device_type == "cuda" and 0 < local_world_size <= cuda_count:
        return "nccl"
    return "gloo"


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else None


def launched_by_torchrun() -> bool:
    """True when the environment describes a process group (``torchrun``)."""
    return all(os.environ.get(k) for k in ("MASTER_ADDR", "MASTER_PORT",
                                           "RANK", "WORLD_SIZE"))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               local_world_size: Optional[int] = None,
               device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group (idempotent). Returns its backend.

    With ``coordinator_address`` ("host:port") the group forms over TCP
    from ``num_processes`` and ``process_id``; without it, from the
    ``torchrun`` environment. ``local_rank`` and ``local_world_size``
    default to ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, else to the process
    id and the process count (every rank on one host). The backend is
    ``choose_backend``'s. Raises RuntimeError when the group's world size
    is not ``num_processes``."""
    if not dist.is_initialized():
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address needs num_processes "
                                 "and process_id")
            world, rank = int(num_processes), int(process_id)
            init_method = f"tcp://{coordinator_address}"
        elif launched_by_torchrun():
            world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
            init_method = "env://"
        else:
            raise RuntimeError(
                "no process group to join: give coordinator_address, "
                "num_processes and process_id, or launch with torchrun")
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK")
        if local_rank is None:
            local_rank = rank
        if local_world_size is None:
            local_world_size = _env_int("LOCAL_WORLD_SIZE") or world
        dev_type = torch.device(device).type
        cuda_count = torch.cuda.device_count() if dev_type == "cuda" else 0
        backend = choose_backend(dev_type, local_world_size, cuda_count)
        os.environ["LOCAL_RANK"] = str(local_rank)
        if dev_type == "cuda":
            torch.cuda.set_device(local_rank % max(cuda_count, 1))
        dist.init_process_group(
            backend=backend, init_method=init_method, world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        print(f"process group: rank {rank} of {world}, backend {backend}, "
              f"device {rank_device(device)}", flush=True)
    if (num_processes or 1) > 1 and dist.get_world_size() != num_processes:
        # e.g. a launcher that started each process as its own group: each
        # would silently train an independent single-process job
        raise RuntimeError(
            f"multihost init expected {num_processes} processes, the group "
            f"has {dist.get_world_size()}")
    return dist.get_backend()


# the captured windows alive in this process's group, held weakly: a
# window's graph holds the group's collectives, and NCCL keeps its
# communicator for each graph that captured them until the graph goes
_LIVE_WINDOWS: "weakref.WeakSet" = weakref.WeakSet()


def track_window(window) -> None:
    """Keep ``window`` (an object with ``release()``) for ``shutdown`` to
    release before the group goes."""
    _LIVE_WINDOWS.add(window)


def untrack_window(window) -> None:
    _LIVE_WINDOWS.discard(window)


def live_windows() -> list:
    """The tracked windows still alive and not released."""
    return list(_LIVE_WINDOWS)


def shutdown() -> None:
    """Leave the process group, once every rank has reached this point (a
    rank that exits while a peer still talks to it, or with the group's
    threads running, can abort the process). Every live captured window
    is released first and the card synced: ``destroy_process_group`` waits
    on a communicator that a live graph still holds. Every rank reaches
    this point together, so no peer still replays a graph released here."""
    if dist.is_initialized():
        for window in live_windows():
            window.release()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.barrier()
        dist.destroy_process_group()


def world_size(group=None) -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def local_rank() -> int:
    return _env_int("LOCAL_RANK") or 0


def is_main() -> bool:
    """True on the rank that owns logging, checkpoint and frame writes."""
    return rank() == 0


def rank_device(device="cuda") -> torch.device:
    """The device rank ``local_rank`` drives: ``cuda:{local_rank %
    device_count}`` for a bare "cuda", the device as given otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return torch.device("cuda", local_rank() % max(count, 1))
    return dev


def local_batch_offset(local_rows: int = 1) -> int:
    """First global-batch row owned by this rank: the ranks hold the
    batch in rank order, ``local_rows`` each."""
    return rank() * local_rows


# --- collectives ----------------------------------------------------------

class Collective(NamedTuple):
    """One collective a step issued: its op, element count and dtype."""

    op: str
    numel: int
    dtype: torch.dtype


def all_reduce_packed(tensors: Sequence[torch.Tensor], op: str = "sum",
                      dtype: torch.dtype = torch.float32,
                      group=None, log: Optional[list] = None):
    """All-reduce ``tensors`` in ONE collective: flattened into one buffer
    of ``dtype``, reduced with ``op`` ("sum" or "max"), and split back to
    new tensors of the inputs' shapes (in ``dtype``). Without a process
    group the values come back as they went in; in a group of one the
    collective still runs (and returns them unchanged).
    ``log``, when given, gets a ``Collective`` of the call."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    if dist.is_initialized():
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        dist.all_reduce(flat, op=red, group=group)
    if log is not None:
        log.append(Collective(op, flat.numel(), dtype))
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def warm_communicator(device) -> None:
    """One eager collective on ``device``, then a sync: the communicator
    exists before a CUDA graph captures collectives (NCCL creates it at its
    first collective, which a capture cannot hold)."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=device))
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def _broadcast_tensor(t: torch.Tensor, src: int, group) -> torch.Tensor:
    if t.dtype == torch.bool:  # gloo has no bool: move the bytes
        buf = t.contiguous().view(torch.uint8)
        dist.broadcast(buf, src=src, group=group)
        return buf.view(torch.bool)
    buf = t.contiguous()
    dist.broadcast(buf, src=src, group=group)
    return buf


def broadcast_tree(tree, src: int = 0, group=None):
    """Replicate rank ``src``'s tensors of a pytree (NamedTuples, tuples,
    lists, dicts) on every rank; other leaves pass unchanged. The JAX
    package's ``global_replicate``: every rank holds the same values
    afterwards, as the replicated optimizer steps need."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree
    if isinstance(tree, torch.Tensor):
        return _broadcast_tensor(tree, src, group)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(broadcast_tree(x, src, group) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(broadcast_tree(x, src, group) for x in tree)
    if isinstance(tree, dict):
        return {k: broadcast_tree(v, src, group) for k, v in tree.items()}
    return tree


# --- local ranks ------------------------------------------------------------

def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank_id: int, world: int, port: int, device,
               args: tuple, results) -> None:
    try:
        if (torch.device(device).type == "cpu"
                and not os.environ.get("OMP_NUM_THREADS")):
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        initialize(f"127.0.0.1:{port}", world, rank_id, local_rank=rank_id,
                   local_world_size=world, device=device)
        out = fn(*args)
        shutdown()
        results.put((rank_id, "ok", out))
    except BaseException:
        # the parent stops every rank: no barrier a peer might never reach
        results.put((rank_id, "error", traceback.format_exc()))
        raise SystemExit(1)


def run_local_ranks(fn: Callable, world: int, args: tuple = (),
                    device="cuda", timeout_s: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``world`` local ranks, each a spawned process
    in one process group on ``device`` (``choose_backend``'s backend, the
    collectives' timeout ``DEFAULT_TIMEOUT_S``). Returns each rank's return
    value (it must pickle), in rank order. A rank that raises, or a run
    longer than ``timeout_s``, stops every rank and raises RuntimeError."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, port, device, args, results)) for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"local ranks ran past {timeout_s} s")
            try:
                rank_id, status, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead and results.empty():
                    time.sleep(1.0)  # let a dying rank's message arrive
                    if results.empty():
                        raise RuntimeError(
                            f"ranks {dead} exited with "
                            f"{[procs[r].exitcode for r in dead]}")
                continue
            if status == "ok":
                out[rank_id] = value
            else:
                errors.append(f"rank {rank_id}:\n{value}")
                break
        if errors:
            raise RuntimeError("a local rank failed\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


# --- per-rank data ------------------------------------------------------------

class GlobalShuffleSampler:
    """Deterministic shared-seed camera-index stream, sliced per rank.

    Every rank constructs the identical stream (same seed => same epoch
    permutations, the same stream as the JAX package's and as
    ``PrefetchLoader``'s for that seed); ``next_global(count)`` advances it
    by one step's global batch and ``local_slice`` cuts out this rank's
    rows: data DECISIONS are global and replicated, data LOADING is
    local."""

    def __init__(self, num_items: int, seed: int = 0, shuffle: bool = True):
        self.num_items = num_items
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self._queue: List[int] = []

    def next_global(self, count: int) -> List[int]:
        self._fill(count)
        out, self._queue = self._queue[:count], self._queue[count:]
        return out

    def peek_global(self, count: int) -> List[int]:
        """The indices the next ``next_global(count)`` will return, WITHOUT
        consuming them (the queue extension is committed), so the trainer
        can decode the next step's images while this one runs."""
        self._fill(count)
        return list(self._queue[:count])

    def _fill(self, count: int) -> None:
        while len(self._queue) < count:
            order = np.arange(self.num_items)
            if self.shuffle:
                self.rng.shuffle(order)
            self._queue.extend(order.tolist())

    @staticmethod
    def local_slice(global_indices: Sequence[int], per_step: int,
                    local_per_step: int, local_offset: int) -> List[int]:
        """Rows of this rank within each step's global batch.

        ``global_indices`` is a window of S steps x per_step cameras; rank
        r (offset = r * local_per_step) owns rows [offset, offset +
        local_per_step) of every step."""
        assert len(global_indices) % per_step == 0
        out: List[int] = []
        for s in range(len(global_indices) // per_step):
            base = s * per_step + local_offset
            out.extend(global_indices[base: base + local_per_step])
        return out


class ThreadedIndexLoader:
    """Load dataset items for explicit index lists on a thread pool.

    Ordering is decided by the sampler, decode happens on threads (PIL
    releases the GIL); ``submit`` returns futures so the trainer can
    overlap the next step's decode with the current step.

    ``expected_hw``: the (h, w) every record's metadata maps to
    (``check_uniform_resolution``). The dataset derives the shape from the
    DECODED image, so a file that disagrees with its metadata would make
    the ranks run different shapes and stall the collectives: each decoded
    item is checked here and the offending image named."""

    def __init__(self, dataset, num_threads: int = 4,
                 expected_hw: Optional[tuple] = None):
        self.dataset = dataset
        self.expected_hw = expected_hw
        self.pool = ThreadPoolExecutor(
            max_workers=max(num_threads, 1),
            thread_name_prefix="mh-dataset-decode")

    def _fetch(self, index: int):
        item = self.dataset[index]
        if self.expected_hw is not None:
            hw = (item.camera_info.camera_height,
                  item.camera_info.camera_width)
            if hw != tuple(self.expected_hw):
                path = None
                try:
                    path = self.dataset.records[index].get("image_path")
                except Exception:
                    pass
                raise ValueError(
                    f"dataset item {index} ({path!r}) decoded to {hw} but "
                    f"its metadata maps to {tuple(self.expected_hw)} — on "
                    "a multihost mesh this would desynchronize the hosts. "
                    "Fix the image file or its camera_height/camera_width "
                    "metadata.")
        return item

    def submit(self, indices: Iterable[int]):
        """Futures for each index, in order (gather with .result())."""
        return [self.pool.submit(self._fetch, i) for i in indices]

    def load(self, indices: Iterable[int]):
        return [f.result() for f in self.submit(indices)]

    def close(self) -> None:
        self.pool.shutdown(wait=False, cancel_futures=True)


def expected_resolution(record: dict, tile_size: int) -> tuple:
    """(h, w) a record will decode to, from metadata alone (the dataset's
    >1600px auto-downscale + tile-multiple crop arithmetic,
    data/dataset.py). Batching across ranks needs a resolution decision
    BEFORE any pixel is read, identically on every rank."""
    h = int(record["camera_height"])
    w = int(record["camera_width"])
    if h > MAX_RESOLUTION_TRAIN or w > MAX_RESOLUTION_TRAIN:
        short, long = (w, h) if w <= h else (h, w)
        scale = 1024 / short
        if long * scale > MAX_RESOLUTION_TRAIN:
            scale = MAX_RESOLUTION_TRAIN / long
        w, h = round(w * scale), round(h * scale)
    return h - h % tile_size, w - w % tile_size


def check_uniform_resolution(records: Sequence[dict], tile_size: int) -> tuple:
    """Multihost training requires one resolution bucket per dataset (all
    ranks must run the SAME shapes each step; mixed resolutions cannot be
    regrouped per rank without pixel reads). Returns the (h, w) every
    record maps to, or raises."""
    sizes = {expected_resolution(r, tile_size) for r in records}
    if len(sizes) != 1:
        raise ValueError(
            "multihost training requires a uniform-resolution dataset; "
            f"metadata maps to {sorted(sizes)}. Re-export the dataset at "
            "one resolution (the reference datasets are uniform).")
    return next(iter(sizes))
