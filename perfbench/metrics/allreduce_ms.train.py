"""Device ms a step in NCCL's all-reduce kernels (``ncclDevKernel_AllReduce*``,
``ncclKernel_AllReduce*``) in rank 0's traced window of a data-parallel
train cell: the collectives of ``parallel/data_parallel.py``
(``multihost.all_reduce_packed``), with any wait for a slower rank, which
the step pays too. None where no such kernel ran."""

PREFIXES = ("ncclDevKernel_AllReduce", "ncclKernel_AllReduce")


def allreduce_s(trace) -> float:
    """Device seconds of the all-reduce kernels in a ``trace.Window``."""
    return sum(s for n, s in trace.device_s.items()
               if n.startswith(PREFIXES))


def read(r):
    if r.kind != "train" or r.trace is None or r.units <= 0:
        return None
    seconds = allreduce_s(r.trace)
    if seconds <= 0:
        return None
    return 1e3 * seconds / r.units
