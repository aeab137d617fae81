"""K3 (``csrc/blend.cu`` ``blend_forward_kernel``) in the render cells:
the frame's least blend time (``work.blend_forward``: bytes over 3.35 TB/s
or operations over 67 TFLOP/s, the larger) over the kernel's device time a
frame in the traced replays."""
from perfbench import work

KERNEL = "blend_forward_kernel"


def read(r):
    if r.kind != "render" or r.trace is None or r.units <= 0:
        return None
    seconds = r.trace.kernel_s(KERNEL) / r.units
    if seconds <= 0:
        return None
    return 100.0 * work.least_seconds(*r.parts["blend_forward"]) / seconds
