"""K4 (``csrc/blend_backward.cu`` ``blend_backward_kernel``) in the train
cells: the step's least blend-backward time (``work.blend_backward``)
over the kernel's device time a step in the traced window."""
from perfbench import work

KERNEL = "blend_backward_kernel"


def read(r):
    if r.kind != "train" or r.trace is None or r.units <= 0:
        return None
    seconds = r.trace.kernel_s(KERNEL) / r.units
    if seconds <= 0:
        return None
    return 100.0 * work.least_seconds(*r.parts["blend_backward"]) / seconds
