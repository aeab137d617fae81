"""The data-parallel step's collectives against their least time: the
bytes the step reduces over the ranks (``work.dp_collective_bytes``, the cell
driver's ``collectives`` part) over NVLink's 450 GB/s a card in each
direction, over the device time a step of NCCL's all-reduce kernels in
rank 0's traced window (``allreduce_ms.train``). None where the cell
reduces nothing or no all-reduce kernel ran."""
from perfbench import cells, work


def read(r):
    if (r.kind != "train" or r.trace is None or r.units <= 0
            or "collectives" not in r.parts):
        return None
    ms = cells.reader("allreduce_ms.train")(r)
    if ms is None:
        return None
    least = r.parts["collectives"][0] / work.NVLINK_BYTES_PER_S
    return 100.0 * least / (ms / 1e3)
