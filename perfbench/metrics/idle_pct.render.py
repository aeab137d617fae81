"""Share of the traced window of the render cells in which no kernel, copy
or set ran on the card (device under ``apps/render.py``)."""


def read(r):
    if r.kind != "render" or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
