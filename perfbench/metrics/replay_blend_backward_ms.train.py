"""Device ms a step inside ``gs.blend_backward``
(``ops/rasterizer.py::rasterize_bwd``: the tile reshapes, K4, the inverse
permutation and K5) in the replayed train windows of the traced run."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "train", "gs.blend_backward")
