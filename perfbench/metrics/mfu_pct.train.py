"""The whole train step's share of the card's float32 peak: the step's
operations (``work.step_parts``: attributes and their VJP, K1-K5, the
loss and its VJP, the two Adams) over the traced window's seconds a step
times 67 TFLOP/s."""
from perfbench import work


def read(r):
    if r.kind != "train" or r.trace is None or r.units <= 0:
        return None
    seconds = r.trace.window_s / r.units
    return 100.0 * work.total_ops(r.parts) / (seconds * work.F32_FLOPS)
