"""The release of captured windows on the CPU: ``multihost.shutdown``
releases every tracked window before the process group goes, in the order
release, card sync, barrier, ``destroy_process_group`` (checked with a
``torch.distributed`` that records the calls and stand-in windows);
``_CapturedWindow.release`` can be called more than once; a window the
trainer drops from its cache is freed at once, with the cyclic collector
off; every way out of a group in the port goes through ``shutdown``; and a
``.json`` config loads without PyYAML. The capture itself needs a card
(tests/test_torch_kernels_cuda.py)."""
import ast
import gc
import weakref
from pathlib import Path

import pytest
import torch

from taichi_3d_gaussian_splatting_tpu_torch.parallel import multihost as mh
from taichi_3d_gaussian_splatting_tpu_torch.training import trainer as ttr
from taichi_3d_gaussian_splatting_tpu_torch.training.config import (
    from_dict,
    load_config,
)
from tests.test_torch_train_loop import _config_dict, write_dataset

PORT = Path(ttr.__file__).resolve().parents[1]


class StandIn:
    """A captured window's interface: ``release`` records itself."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def release(self):
        self.calls.append(("release", self.name))
        mh.untrack_window(self)


@pytest.fixture
def recorded_group(monkeypatch):
    """A process group that exists until ``destroy_process_group``, whose
    calls (and the card syncs) go to the returned list."""
    calls, alive = [], [True]
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: alive[0])
    monkeypatch.setattr(mh.dist, "barrier",
                        lambda *a, **k: calls.append(("barrier",)))

    def destroy(*a, **k):
        calls.append(("destroy",))
        alive[0] = False
    monkeypatch.setattr(mh.dist, "destroy_process_group", destroy)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(("sync",)))
    yield calls
    for w in mh.live_windows():
        mh.untrack_window(w)


def test_shutdown_releases_every_window_before_the_group_goes(
        recorded_group):
    calls = recorded_group
    a, b, dropped = (StandIn(n, calls) for n in "abc")
    mh.track_window(a)
    mh.track_window(b)
    mh.track_window(dropped)
    del dropped  # held weakly: a window gone is not released
    gc.collect()
    assert sorted(w.name for w in mh.live_windows()) == ["a", "b"]
    mh.shutdown()
    assert sorted(calls[:2]) == [("release", "a"), ("release", "b")]
    assert calls[2:] == [("sync",), ("barrier",), ("destroy",)]
    assert mh.live_windows() == []
    mh.shutdown()  # no group left: nothing more
    assert len(calls) == 5


def test_shutdown_without_a_group_releases_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: False)
    w = StandIn("a", calls)
    mh.track_window(w)
    try:
        mh.shutdown()
        assert calls == [] and mh.live_windows() == [w]
    finally:
        mh.untrack_window(w)


class FakeGraph:
    resets = 0

    def reset(self):
        self.resets += 1


def test_release_can_be_called_more_than_once():
    """``release`` resets the graph once, drops the static inputs, state,
    metrics and aux, and leaves the windows ``multihost`` tracks; a second
    call does nothing."""
    window = ttr._CapturedWindow.__new__(ttr._CapturedWindow)
    graph = FakeGraph()
    window.graph = graph
    window.inputs = (torch.zeros(2), None)
    window.state = torch.zeros(3)
    window.metrics = {"loss": torch.zeros(2)}
    window.aux = {"pred": torch.zeros(1)}
    mh.track_window(window)
    window.release()
    window.release()
    assert graph.resets == 1
    assert (window.graph, window.inputs, window.state, window.metrics,
            window.aux) == (None,) * 5
    assert window not in mh.live_windows()


def test_a_released_graph_is_captured_anew(monkeypatch):
    """A window whose graph was released (by ``shutdown``) captures a new
    one at its next call instead of replaying the released one; the old
    one is released first (again: a no-op)."""
    made = []

    class Captured:
        def __init__(self, run, state, inputs, sh_band, counters=False):
            self.graph, self.released = object(), 0
            made.append(self)

        def __call__(self, state, inputs):
            return state, {}, None

        def release(self):
            self.released += 1
            self.graph = None

    monkeypatch.setattr(ttr, "_CapturedWindow", Captured)
    window = ttr._Window(lambda *a: None, 2, torch.device("cpu"), False)
    window.mode = "graph"
    state = ttr.TrainState(scene=type("S", (), {"capacity": 8})(),
                           feat_opt=None, pos_opt=None, ctrl=None)
    images = torch.zeros(2, 4, 4, 3)
    window(state, images, None, None, None, 1)
    window(state, images, None, None, None, 1)  # a replay
    assert window.captures == 1
    made[0].release()
    window(state, images, None, None, None, 1)
    assert window.captures == 2 and len(made) == 2
    assert made[0].released == 2 and list(window.graphs.values()) == [
        made[1]]
    window(state, images, None, None, None, 2)  # another band
    assert window.captures == 3 and made[1].released == 1


@pytest.mark.parametrize("drop", ["refit", "downsample"])
def test_a_window_dropped_from_the_trainer_cache_is_freed_at_once(
        tmp_path, drop):
    """With the cyclic collector off, a window the trainer drops from its
    step cache (at a key-capacity refit, or at a downsample change as
    ``train()`` drops them) is freed at ``del``, and so is the captured
    window it holds (a stand-in here: a capture needs a card)."""
    data = write_dataset(tmp_path)
    config = from_dict(_config_dict(
        data, tmp_path / "logs", steps_per_dispatch=2,
        rasterisation_config={"tile_size": 32, "key_cap": 2 ** 20}))
    trainer = ttr.GaussianPointCloudTrainer(config, device="cpu")
    gc.collect()
    gc.disable()
    try:
        window = trainer._get_step(64, 64, 2)
        captured = StandIn("captured", [])
        window.graphs[("key",)] = captured
        refs = weakref.ref(window), weakref.ref(captured)
        del captured
        if drop == "refit":
            trainer._maybe_rebucket_key_cap(100)  # 2^20 -> 2^19
            assert trainer._key_cap == 2 ** 19
        else:  # train()'s drop at a downsample change
            trainer._step_cache = {k: v for k, v in
                                   trainer._step_cache.items()
                                   if len(k) < 4 or k[3] == 0}
        assert not trainer._step_cache
        assert all(r() is not None for r in refs)
        del window
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
        if trainer.writer is not None:
            trainer.writer.close()


def _calls(tree, name):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call) and (
        getattr(n.func, "attr", None) == name
        or getattr(n.func, "id", None) == name)]


def _function(tree, name):
    (fn,) = [n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return fn


@pytest.mark.parametrize("path, function", [
    ("parallel/multihost.py", "_rank_main"),
    ("apps/train.py", "main"),
    ("apps/render.py", "main"),
    ("parallel/mh_smoke.py", "main"),
])
def test_every_way_out_of_a_group_goes_through_shutdown(path, function):
    """Each place that ends a rank's group calls ``shutdown``; no module of
    the port destroys a group but ``multihost.shutdown``."""
    tree = ast.parse((PORT / path).read_text())
    assert _calls(_function(tree, function), "shutdown")
    found = [(file.name, call.lineno) for file in PORT.rglob("*.py")
             for call in _calls(ast.parse(file.read_text()),
                                "destroy_process_group")]
    shutdown = _function(ast.parse((PORT / "parallel/multihost.py")
                                   .read_text()), "shutdown")
    assert [(name, shutdown.lineno <= line <= shutdown.end_lineno)
            for name, line in found] == [("multihost.py", True)]


def test_json_config_loads_without_yaml(tmp_path, monkeypatch):
    """A ``.json`` config is read with the standard library (a machine
    without PyYAML runs ``apps.train`` on it), as its YAML twin reads."""
    import builtins
    import json

    fields = {"num_iterations": 12, "steps_per_dispatch": 8,
              "data_parallel_devices": 4,
              "rasterisation_config": {"tile_size": 16}}
    path = tmp_path / "c.json"
    path.write_text(json.dumps(fields))
    real_import = builtins.__import__

    def no_yaml(name, *a, **k):
        if name == "yaml":
            raise ImportError("no yaml")
        return real_import(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_yaml)
    assert load_config(str(path)) == from_dict(fields)
