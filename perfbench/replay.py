"""Device ms a unit by the program's ``gs.*`` stage under graph replay:
the readings of the port's ``ops/stages.py`` (``read()``), made while the
traced window ran under the profiler. None off the card, for another
traffic kind, and where the program makes no such reading (a program
without ``ops/stages.py``, or no replay read)."""


def stage_ms(r, kind: str, name: str):
    """``read().ms[name]`` for the traffic ``kind``, else None."""
    if r.kind != kind or r.trace is None:
        return None
    try:
        from taichi_3d_gaussian_splatting_tpu_torch.ops import stages
    except ImportError:
        return None
    got = stages.read()
    return got.ms.get(name) if got.units else None
