"""Share of the traced window of the train cells in which no kernel, copy
or set ran on the card (device under ``training/trainer.py``)."""


def read(r):
    if r.kind != "train" or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
