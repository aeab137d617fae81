"""Device ms a step inside ``gs.attributes_vjp``
(``ops/rasterizer.py`` ``attrs_vjp``: autograd of ``compute_raw_attrs``)
in the replayed train windows of the traced run."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "train", "gs.attributes_vjp")
