"""The whole frame's share of the card's float32 peak: the frame's
operations (``work.frame_parts``: attributes, K1-K3) over the traced
window's seconds a frame times 67 TFLOP/s."""
from perfbench import work


def read(r):
    if r.kind != "render" or r.trace is None or r.units <= 0:
        return None
    seconds = r.trace.window_s / r.units
    return 100.0 * work.total_ops(r.parts) / (seconds * work.F32_FLOPS)
