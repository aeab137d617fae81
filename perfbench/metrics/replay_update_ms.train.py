"""Device ms a step inside ``gs.update`` (the grad factors,
``controller.accumulate``, the step metrics and
``training/trainer.py::apply_grads``, two Adams) in the replayed train
windows of the traced run."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "train", "gs.update")
