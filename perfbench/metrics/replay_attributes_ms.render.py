"""Device ms a frame inside ``gs.attributes``
(``ops/rasterizer.py::compute_raw_attrs``) in the replayed frames of the
traced window (``attrs_ms.render`` reads eager frames after it)."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "render", "gs.attributes")
