"""Device ms a frame inside the program's ``gs.tiling`` range
(``ops/tiling.py``: cull, K1, the sort, K2), from eager frames at the
cell's poses and fitted capacity after the window."""


def read(r):
    if r.kind != "render" or not r.stages:
        return None
    return r.stages.get("gs.tiling")
