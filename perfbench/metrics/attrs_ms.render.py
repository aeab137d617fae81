"""Device ms a frame inside the program's ``gs.attributes`` range
(``ops/rasterizer.py::compute_raw_attrs``), from eager frames at the
cell's poses and fitted capacity after the window."""


def read(r):
    if r.kind != "render" or not r.stages:
        return None
    return r.stages.get("gs.attributes")
