"""Device ms a frame inside ``gs.tiling`` (``ops/tiling.py``: cull,
K1, the sort, K2) in the replayed frames of the traced window
(``tiling_ms.render`` reads eager frames after it)."""
from perfbench import replay


def read(r):
    return replay.stage_ms(r, "render", "gs.tiling")
