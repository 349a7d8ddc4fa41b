"""The measured window and its arithmetic.

A closed loop: the user's job makes its next call (a block of training steps
or one frame) when the last one has ended, and every call ends in a host read
of its result, so the host clock around the calls times the device's work.
The window runs whole calls until ``seconds`` have passed; its rates are
taken over all of its work and all of its time.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Tuple


@dataclasses.dataclass
class Window:
    seconds: float              # first call's start to the last call's host read
    calls: List[float]          # each call's seconds
    units: int                  # steps or frames completed
    failed: int                 # units of calls whose result was not finite


def run_window(call: Callable[[int], Tuple[int, float]], seconds: float,
               max_calls: int = 0, first: int = 0) -> Window:
    """Calls ``call(k)`` for ``k = first, first + 1, ...`` (each returning its
    units and the value the host read) until ``seconds`` have passed, or
    ``max_calls`` calls when that is set."""
    times, units, failed = [], 0, 0
    start = time.perf_counter()
    end = start
    while True:
        t = time.perf_counter()
        n, value = call(first + len(times))
        end = time.perf_counter()
        times.append(end - t)
        units += n
        if value is not None and not math.isfinite(value):
            failed += n
        if (max_calls and len(times) >= max_calls) or (not max_calls and end - start >= seconds):
            break
    return Window(end - start, times, units, failed)


def rate(units: float, seconds: float) -> float:
    return units / seconds


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank: the smallest value with at least a
    share ``q`` of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]
