"""The program's ``gs.*`` stages (``ops/stages.py``): the ranges of a train
step and of an eager render frame under ``torch.profiler``, a stage that
makes no CUDA call outside a capture, and the readings of graph replays.

The tests marked ``cuda`` capture and replay graphs on a card and skip
elsewhere; this file imports no JAX, so they run on a machine without it:

    python -m pytest tests/test_torch_stages.py --noconftest -q
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from taichi_3d_gaussian_splatting_tpu_torch.apps import render as app
from taichi_3d_gaussian_splatting_tpu_torch.convert import (
    scene_from_jax_arrays,
)
from taichi_3d_gaussian_splatting_tpu_torch.ops import cuda_build, histogram
from taichi_3d_gaussian_splatting_tpu_torch.ops import rasterizer as R
from taichi_3d_gaussian_splatting_tpu_torch.ops import stages
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer
from taichi_3d_gaussian_splatting_tpu_torch.training.config import TrainConfig
from tests.torch_port_scenes import Q_ID, T_ID, make_K, make_scene

TRAIN_STAGES = ("gs.attributes", "gs.tiling", "gs.blend", "gs.loss",
                "gs.blend_backward", "gs.attributes_vjp", "gs.update")
RENDER_STAGES = ("gs.attributes", "gs.tiling", "gs.blend", "gs.assemble")


@pytest.fixture(autouse=True)
def fresh_readings():
    stages.reset()
    yield
    stages.reset()


def _state_and_views(dev, k):
    xyz, feats, invalid = make_scene(200, 7)
    config = TrainConfig(rasterisation_config=R.RasterizerConfig(tile_size=32))
    state = trainer.init_train_state(
        scene_from_jax_arrays(xyz, feats, invalid, device=dev), config)
    rng = np.random.default_rng(1)
    views = (
        torch.from_numpy((rng.random((k, 64, 64, 3)) * 255).astype(
            np.uint8)).to(dev),
        torch.from_numpy(np.tile(Q_ID, (k, 1))).to(dev),
        torch.from_numpy(rng.normal(0, 0.02, (k, 3)).astype(
            np.float32)).to(dev),
        torch.from_numpy(np.tile(make_K(), (k, 1, 1))).to(dev))
    return config, state, views


def _gs_ranges(prof):
    """The profiler's ``gs.*`` ranges as (start, end, name), by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.name.startswith("gs."))


def _first_seen(names):
    seen = []
    for n in names:
        if n not in seen:
            seen.append(n)
    return seen


@pytest.fixture
def no_cuda(monkeypatch):
    """Any CUDA event, capture query, synchronise or kernel build raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call outside a capture")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)


def test_a_cpu_train_step_shows_the_seven_stages_in_order(no_cuda):
    """One CPU train step under the profiler: attributes, tiling, blend,
    loss, blend_backward, attributes_vjp, update, in that order (the grad
    factors open a first ``gs.update`` inside ``camera_pass``), with no
    mark and no CUDA call; the frame's tile counters are recorded at
    once."""
    config, state, views = _state_and_views("cpu", 1)
    step = trainer.make_train_step(config, 64, 64, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, *(v[0] for v in views), 3)
    names = [r[2] for r in _gs_ranges(prof)]
    assert tuple(_first_seen(names)) == TRAIN_STAGES
    assert names.count("gs.update") == 2
    got = stages.read()
    assert got[:2] == (0, {})
    assert set(got.counts) == set(histogram.TILE_COUNTS)


def test_an_eager_frame_has_the_four_render_stages_and_none_inside(no_cuda):
    """``rasterize``'s eager frame has exactly gs.attributes, gs.tiling,
    gs.blend and gs.assemble, one each, and no ``gs.*`` range nested inside
    another (``perfbench/trace.stage_ms`` takes the innermost one)."""
    xyz, feats, invalid = make_scene(200, 7)
    to = torch.from_numpy
    cfg = R.RasterizerConfig(tile_size=32, rgb_only=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        R.rasterize(to(xyz), to(feats), to(invalid), to(Q_ID), to(T_ID),
                    R.Camera(to(make_K()), 64, 64), cfg, key_cap=4096)
    ranges = _gs_ranges(prof)
    assert [r[2] for r in ranges] == list(RENDER_STAGES)
    for (s0, e0, _), (s1, _, _) in zip(ranges, ranges[1:]):
        assert e0 <= s1


def test_a_stage_outside_a_capture_is_the_profiler_range_alone(no_cuda):
    """Outside ``capturing()`` a stage marks nothing and asks the card
    nothing, with or without a profiler; ``set_unit`` does nothing. Inside
    it, before ``Record.allocate`` (the warm-up), a stage counts its two
    marks and launches nothing."""
    stages.set_unit(3)
    with stages.stage("gs.outer"):
        with stages.stage("gs.inner"):
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with stages.stage("gs.outer"):
            pass
    assert [r[2] for r in _gs_ranges(prof)] == ["gs.outer"]
    assert stages._capture is None
    with stages.capturing() as rec:
        with stages.stage("gs.outer"):
            with stages.stage("gs.inner"):
                pass
    assert (rec.counted, rec.used, rec.marks) == (4, 0, [])
    assert stages._capture is None


class FakeDone:
    """The event recorded after a replay under a profiler; ``query()``
    reads the shared flag."""

    def __init__(self, done):
        self.done = done

    def record(self):
        pass

    def query(self):
        return self.done[0]


class FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


def _fake_record(done):
    """A record of two units: gs.a 1 ms and gs.b 2 ms in unit 0, gs.a
    3 ms (with gs.c of 1 ms inside it) in unit 1; a span of 10 ms."""
    rec = stages.Record()
    rec.slots = torch.tensor([0, 1, 2, 4, 5, 6, 7, 8, 10]) * 1_000_000
    rec.counted = rec.used = 9
    rec.marks = [stages.Mark(0, "gs.a", 0, 0, 1),
                 stages.Mark(0, "gs.b", 0, 2, 3),
                 stages.Mark(1, "gs.c", 1, 5, 6),
                 stages.Mark(1, "gs.a", 0, 4, 7),
                 stages.Mark(1, "gs.d", 0, 8, 8)]
    rec.unit = 1
    rec.done = FakeDone(done)
    return rec


def test_read_is_empty_with_no_replay_and_with_no_profiler(no_cuda):
    """No replay: nothing read. Replays made with no profiler active:
    nothing read, nothing held, no CUDA call."""
    assert stages.read() == (0, {}, {})
    graph, rec = FakeGraph(), _fake_record([True])
    for _ in range(3):
        stages.replay(graph, rec)
    assert graph.replays == 3
    assert stages.read() == (0, {}, {}) and stages._pending == []


def test_replays_under_a_profiler_are_read_per_unit(monkeypatch):
    """Under a profiler a replay is read at the next replay call if it
    has completed, else dropped (the next replay overwrites
    it); ``read()`` synchronises and reads the last one. ms a unit by
    stage, nested stages counted in their own name only, ``(unmarked)``
    the span's rest; a released graph's unread record is still read."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1))
    done = [True]
    graph, rec = FakeGraph(), _fake_record(done)
    with profile(activities=[ProfilerActivity.CPU]):
        stages.replay(graph, rec)       # read at the next call
        stages.replay(graph, rec)       # unfinished at the next call:
        done[0] = False
        stages.replay(graph, rec)       # dropped
        done[0] = True
    del graph                           # the record outlives its graph
    got = stages.read()
    assert syncs == [1]
    assert got.units == 4
    assert got.ms == pytest.approx({"gs.a": 2.0, "gs.b": 1.0, "gs.c": 0.5,
                                    "gs.d": 0.0, stages.UNMARKED: 2.0})
    assert stages.read() == got         # read() is idempotent


def test_counters_are_read_beside_the_marks(monkeypatch):
    """A record whose counter slots lie between its marks: the counters'
    mean over the records read, beside ms a unit that the counter slots do
    not change; the warm-up of a capture that records counters counts
    their slots and fills nothing, any other capture takes none; outside a
    capture the CPU records at once."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    rec = _fake_record([True])
    # slots 9-11: the counters of unit 0, after gs.b; the span ends at 8
    rec.slots = torch.cat([rec.slots, torch.zeros(3, dtype=torch.int64)])
    rec.counted = rec.used = 12
    rec.counters = [("keys_max", 9), ("keys", 10), ("tiles", 11)]
    written = iter([[70, 900, 12], [90, 1100, 14]])

    class Graph:
        def replay(self):  # the replay writes its counters
            rec.slots[9:12] = torch.tensor(next(written))

    with profile(activities=[ProfilerActivity.CPU]):
        stages.replay(Graph(), rec)
        stages.replay(Graph(), rec)
    got = stages.read()
    assert got.units == 4
    assert got.ms[stages.UNMARKED] == pytest.approx(2.0)
    assert got.counts == {"keys_max": 80.0, "keys": 1000.0, "tiles": 13.0}

    def fill(out):
        raise AssertionError("the warm-up fills no counter")

    with stages.capturing(counters=True) as warm:
        stages.count(("a", "b"), fill, "cuda")
    assert (warm.counted, warm.used, warm.counters) == (2, 0, [])
    with stages.capturing() as warm:  # a render graph's, a DP window's
        stages.count(("a", "b"), fill, "cuda")
    assert (warm.counted, warm.used, warm.counters) == (0, 0, [])
    stages.reset()
    stages.count(("a", "b"), lambda out: out.copy_(torch.tensor([3, 4])),
                 "cpu")
    stages.count(("a", "b"), lambda out: out.copy_(torch.tensor([5, 8])),
                 "cpu")
    assert stages.read() == (0, {}, {"a": 4.0, "b": 6.0})


def test_counters_outside_a_capture_on_a_card_run_nothing(no_cuda):
    def fill(out):
        raise AssertionError("no counter on a card outside a capture")

    stages.count(("a",), fill, "cuda")
    assert stages.read() == (0, {}, {})


def _mark_ms_against_profiler(dev):
    """Stage marks of a captured graph against the profiler's device ms
    of the same kernels, over replays read under a profiler."""
    x = torch.randn(2 ** 24, device=dev)

    def run():
        a = torch.cos(x)
        with stages.stage("gs.sin"):
            for _ in range(20):
                a = torch.sin(a)
        with stages.stage("gs.exp"):
            for _ in range(20):
                a = torch.exp(a * 1e-3)
        return a

    graph, _, _, rec = trainer.capture_graph(run, dev)
    n = 10
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            stages.replay(graph, rec)
            torch.cuda.synchronize()  # each replay read at the next
    got = stages.read()
    kernels = {"gs.sin": 0.0, "gs.exp": 0.0}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if "sin_kernel" in e.name():
            kernels["gs.sin"] += e.duration_ns() / 1e6 / n
        elif "exp_kernel" in e.name() or "MulFunctor" in e.name():
            kernels["gs.exp"] += e.duration_ns() / 1e6 / n
    return got, kernels


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stage_marks_match_the_profilers_kernel_time(dev):
    """Under replay, a stage's ms between its marks is its kernels' device
    ms as the profiler reads them, within 5%: the marks time the
    replays."""
    got, kernels = _mark_ms_against_profiler(dev)
    assert got.units == 10
    for name, ms in kernels.items():
        assert ms > 0
        assert got.ms[name] == pytest.approx(ms, rel=0.05), (got, kernels)


@pytest.mark.cuda
def test_a_window_read_after_one_replay_holds_every_train_stage(dev):
    """A captured window of 8 steps read after one replay under a profiler
    holds 8 units; every train stage, and the state copy, is > 0; and the
    stages cover all but under 5% of the span from the window's first
    mark to its last."""
    config, state, views = _state_and_views(dev, 8)
    window = trainer.make_train_step(config, 64, 64, scan_steps=8,
                                     device=dev, key_cap=4096)
    state = window(state, *views, 3)[0]  # warm-up, capture, a replay
    torch.cuda.synchronize()
    stages.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        window(state, *views, 3)
    got = stages.read()
    assert got.units == 8
    for name in TRAIN_STAGES + ("gs.state_copy",):
        assert got.ms[name] > 0, name
    span = sum(got.ms.values())
    assert got.ms[stages.UNMARKED] < 0.05 * span, got


@pytest.mark.cuda
def test_a_window_replayed_with_no_profiler_is_not_read(dev):
    config, state, views = _state_and_views(dev, 8)
    window = trainer.make_train_step(config, 64, 64, scan_steps=8,
                                     device=dev, key_cap=4096)
    for _ in range(3):
        state = window(state, *views, 3)[0]
    assert stages.read() == (0, {}, {}) and stages._pending == []


@pytest.mark.cuda
def test_frame_graph_replays_give_one_reading_a_frame(dev):
    """The renderer's graph frames, each ended by its copy to the host, are
    read one unit a frame, with every render stage > 0, also after the
    graph is released."""
    xyz, feats, invalid = make_scene(200, 7)
    cfg = R.RasterizerConfig(tile_size=32, rgb_only=True)
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    scene = to(xyz), to(feats), to(invalid)

    def frame(q, t):
        return R.rasterize(*scene, q, t, cam, cfg, key_cap=4096).rgb

    graph = app.FrameGraph(frame, (to(Q_ID), to(T_ID)), dev)
    graph(to(Q_ID), to(T_ID))
    frames = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(frames):
            app.GaussianPointRenderer._to_frame(graph(to(Q_ID), to(T_ID)))
    graph.release()
    got = stages.read()
    assert got.units == frames
    for name in RENDER_STAGES:
        assert got.ms[name] > 0, name


@pytest.mark.cuda
def test_tile_counts_kernel_equals_its_plain_version(dev):
    """``histogram.tile_counts`` on the card: the heaviest tile, the kept
    keys and the tiles that hold a key, as the plain version gives them,
    over empty frames, a tile count past the block's 1024 threads and
    one heavy tile."""
    g = torch.Generator().manual_seed(3)
    for tiles in (0, 1, 17, 950, 3000):
        n = torch.randint(0, 40, (tiles,), generator=g, dtype=torch.int32)
        n[torch.rand(tiles, generator=g) < 0.3] = 0
        if tiles > 5:
            n[5] = 70_000
        bounds = torch.cat([torch.zeros(1, dtype=torch.int32),
                            torch.cumsum(n, 0, dtype=torch.int32)])
        want = torch.empty(3, dtype=torch.int64)
        histogram.tile_counts_plain(bounds, want)
        got = torch.full((3,), -1, dtype=torch.int64, device=dev)
        histogram.tile_counts(bounds.to(dev), got)
        assert got.cpu().tolist() == want.tolist(), tiles


@pytest.mark.cuda
def test_a_replayed_frame_reads_its_tile_counters(dev):
    """A capped frame captured with counters: its tile counters, read
    from replays under a profiler, are the plain summary of the tile
    ranges the replay wrote; captured without (as a render graph is), it
    records none and launches no counter kernel; the single-device window
    of 8 steps reads one record of them a step."""
    xyz, feats, invalid = make_scene(200, 7)
    cfg = R.RasterizerConfig(tile_size=32, rgb_only=True)
    cam = R.Camera(torch.from_numpy(make_K()).to(dev), 64, 64)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    scene = to(xyz), to(feats), to(invalid)
    q, t = to(Q_ID), to(T_ID)

    def frame():
        raw, radius = R.compute_raw_attrs(scene[0], scene[1], q, t, cam)
        keys, _, _ = R.build_keys(raw, radius, scene[2], cam, cfg, 4096)
        return keys.tile_start, keys.tile_end

    launches = histogram.tile_counts.launches
    graph, (start, end), _, rec = trainer.capture_graph(frame, dev,
                                                        counters=True)
    assert histogram.tile_counts.launches == launches + 1  # the capture's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            stages.replay(graph, rec)
    n = (end - start).long().cpu()
    assert stages.read().counts == {
        "tile_keys_max": int(n.max()), "tile_keys_kept": int(n.sum()),
        "tiles_nonempty": int((n > 0).sum())}
    assert int(n.sum()) > 0
    stages.reset()
    graph, _, _, rec = trainer.capture_graph(frame, dev)
    assert histogram.tile_counts.launches == launches + 1
    assert rec.counters == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        stages.replay(graph, rec)
    assert stages.read().counts == {}
    stages.reset()
    config, state, views = _state_and_views(dev, 8)
    window = trainer.make_train_step(config, 64, 64, scan_steps=8,
                                     device=dev, key_cap=4096)
    state = window(state, *views, 3)[0]
    torch.cuda.synchronize()
    stages.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        window(state, *views, 3)
    got = stages.read()
    assert got.units == 8
    assert set(got.counts) == set(histogram.TILE_COUNTS)
    assert stages._count_records["tiles_nonempty"] == 8
