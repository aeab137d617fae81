"""Device ms a step inside ``gs.loss`` (``training/trainer.py::camera_pass``:
the clamp, ``training/loss.py::compute_loss``, L1 + SSIM, its VJP and the
clamp mask) in the replayed train windows of the traced run."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "train", "gs.loss")
