"""The window's arithmetic: rates over whole calls, calls numbered on from
the given one, the 90th percentile over all frames."""

import math

from harness import window


def test_window_runs_whole_calls_until_its_time_has_passed(monkeypatch):
    clock = iter(range(100))
    monkeypatch.setattr(window.time, "perf_counter", lambda: float(next(clock)))
    # Each call takes one tick between its two readings.
    win = window.run_window(lambda k: (64, 0.5), seconds=5.0)
    assert win.units == 64 * len(win.calls)
    assert win.seconds >= 5.0
    assert window.rate(win.units, win.seconds) == win.units / win.seconds
    assert win.failed == 0


def test_a_call_whose_result_is_not_finite_counts_its_units_failed():
    win = window.run_window(lambda k: (13, math.nan if k == 1 else 1.0), 0.0, max_calls=3)
    assert (win.units, win.failed, len(win.calls)) == (39, 13, 3)


def test_a_window_numbers_its_calls_on_from_the_first():
    seen = []
    win = window.run_window(lambda k: (seen.append(k), (1, 1.0))[1], 0.0, max_calls=3, first=8)
    assert seen == [8, 9, 10] and win.units == 3


def test_p90_over_all_frames_keeps_ten_beyond_it():
    values = [float(v) for v in range(1, 101)]
    p90 = window.nearest_rank(values, 0.9)
    assert p90 == 90.0
    assert sum(v > p90 for v in values) == 10
    assert window.nearest_rank([3.0], 0.9) == 3.0

