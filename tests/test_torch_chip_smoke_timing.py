"""chip_smoke.py's device-time readers on the CPU, with the profiler
replaced by canned windows: a time is read only from a window that shows
the call's own kernels, a window without them, or one that lost more than
a tenth of some kernel's events, is taken again, and the third such window
fails the run. A window that lost fewer is read from the events it kept."""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def canned(monkeypatch, cs, windows):
    """profile_device returns the given windows of (name, us, count) rows
    in turn; returns the list of windows taken."""
    taken = []

    def profile_device(fn, reps):
        rows = windows[len(taken)]
        taken.append(rows)
        return 1.0, rows
    monkeypatch.setattr(cs, "profile_device", profile_device)
    return taken


K = "tile_ranges_kernel(int const*, int*, int, int, int)"
OTHER = "void at::native::vectorized_elementwise_kernel<4, ...>(...)"


@pytest.mark.parametrize("misses", [0, 1, 2])
def test_kernel_ms_reads_the_first_window_with_the_kernel(monkeypatch, cs,
                                                          misses):
    windows = [[(OTHER, 7.0, 10)]] * misses + [[(K, 30.0, 10),
                                                 (OTHER, 7.0, 10)]]
    taken = canned(monkeypatch, cs, windows)
    assert cs.kernel_ms(lambda: None, "tile_ranges_kernel", reps=10) == (
        pytest.approx(0.003))
    assert len(taken) == misses + 1


@pytest.mark.parametrize("window", [
    [],                                  # no device event at all
    [(OTHER, 7.0, 10)],                  # other kernels only
    [(K, 3.0, 1), (OTHER, 7.0, 10)],     # fewer launches than calls
])
def test_three_windows_without_the_kernel_fail(monkeypatch, cs, window):
    taken = canned(monkeypatch, cs, [window] * 3)
    with pytest.raises(AssertionError, match="three profiler windows"):
        cs.kernel_ms(lambda: None, "tile_ranges_kernel", reps=10)
    assert len(taken) == 3


def test_device_ms_needs_every_expected_event(monkeypatch, cs):
    search = "void at::native::searchsorted_cuda_kernel<int, int>(...)"
    windows = [[(OTHER, 7.0, 10)],
               [(search, 40.0, 10), (OTHER, 10.0, 10)]]
    taken = canned(monkeypatch, cs, windows)
    ms = cs.device_ms(lambda: None, 10, expect=("searchsorted",) + cs.EW)
    assert ms == pytest.approx(0.005)  # all of the call's events, a call
    assert len(taken) == 2


def test_device_busy_window_must_show_the_kernel(monkeypatch, cs):
    canned(monkeypatch, cs, [[(OTHER, 7.0, 5)]] * 3)
    with pytest.raises(AssertionError):
        cs.device_busy(lambda: None, 5, expect=("blend_forward_kernel(",))


def test_a_few_lost_events_are_read_from_the_kept_ones(monkeypatch, cs):
    search = "void at::native::searchsorted_cuda_kernel<int, int>(...)"
    # 50 calls, each one searchsorted launch and two elementwise ones; the
    # window lost one of the first and three of the second
    window = [(search, 49 * 5.0, 49), (OTHER, 97 * 2.0, 97)]
    taken = canned(monkeypatch, cs, [window])
    monkeypatch.setattr(cs, "WINDOWS",
                        {"taken": 0, "retaken": 0, "events_lost": 0})
    assert cs.device_ms(lambda: None, 50, expect=("searchsorted",)) == (
        pytest.approx(0.009))  # 5 us + 2 x 2 us a call
    assert len(taken) == 1
    assert cs.WINDOWS == {"taken": 1, "retaken": 0, "events_lost": 4}
    taken.clear()
    assert cs.kernel_ms(lambda: None, "searchsorted_cuda_kernel<int, int>",
                        reps=50) == pytest.approx(0.005)


@pytest.mark.parametrize("kept", [44, 26, 51])
def test_a_window_that_lost_too_many_events_is_taken_again(monkeypatch, cs,
                                                           kept):
    good = [(K, 50 * 2.4, 50)]
    taken = canned(monkeypatch, cs, [[(K, kept * 2.4, kept)], good])
    monkeypatch.setattr(cs, "WINDOWS",
                        {"taken": 0, "retaken": 0, "events_lost": 0})
    assert cs.kernel_ms(lambda: None, "tile_ranges_kernel", reps=50) == (
        pytest.approx(0.0024))
    assert len(taken) == 2
    assert cs.WINDOWS == {"taken": 2, "retaken": 1, "events_lost": 0}


def test_device_busy_scales_lost_events_to_every_call(monkeypatch, cs):
    canned(monkeypatch, cs, [[(K, 19 * 3.0, 19), (OTHER, 40 * 1.0, 40)]])
    busy = cs.device_busy(lambda: None, 20, expect=("tile_ranges_kernel(",))
    assert busy["device_busy_ms"] == pytest.approx(0.1)  # 20 x (3 + 2) us
    assert busy["busy_share"] == pytest.approx(0.1)  # of the 1 ms window


def test_other_names_with_extra_events_count_as_they_stand(monkeypatch, cs):
    # 2 calls of a plain blend: its elementwise kernels twice each, and 5
    # copies (a count that is no whole number a call): the window is read
    # as it stands, not taken again
    copy = "Memcpy DtoD (Device -> Device)"
    taken = canned(monkeypatch, cs, [[(OTHER, 4 * 3.0, 4),
                                      (copy, 5 * 1.0, 5)]])
    monkeypatch.setattr(cs, "WINDOWS",
                        {"taken": 0, "retaken": 0, "events_lost": 0})
    assert cs.device_ms(lambda: None, 2, expect=cs.EW) == (
        pytest.approx(0.0085))  # 2 x 3 us + 5 x 1 us / 2, a call
    assert len(taken) == 1
    assert cs.WINDOWS == {"taken": 1, "retaken": 0, "events_lost": 0}
