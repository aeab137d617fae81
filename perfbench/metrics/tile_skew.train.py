"""The train cells' key skew over the tiles (``ops/tiling.py`` build_keys,
the tile counters that ``ops/stages.py`` records in the replayed windows of
the traced run): the heaviest tile's kept keys, mean over the window's
steps, over the mean kept keys of a tile that holds one (the steps' kept
keys over their non-empty tiles). None off the card, for another traffic
kind, and where the program records no tile counters."""

NAMES = ("tile_keys_max", "tile_keys_kept", "tiles_nonempty")


def read(r):
    if r.kind != "train" or r.trace is None:
        return None
    try:
        from taichi_3d_gaussian_splatting_tpu_torch.ops import stages
    except ImportError:
        return None
    counts = getattr(stages.read(), "counts", None) or {}
    if any(counts.get(name, 0) <= 0 for name in NAMES):
        return None
    heaviest, kept, tiles = (counts[name] for name in NAMES)
    return heaviest / (kept / tiles)
