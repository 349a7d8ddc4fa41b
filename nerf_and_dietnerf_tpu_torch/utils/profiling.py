"""Profiling and debugging hooks.

Port of ``nerf_and_dietnerf_tpu/utils/profiling.py``:

- :func:`trace`: context manager around ``torch.profiler.profile`` (CPU and,
  with a GPU, CUDA activities); writes a Chrome trace into ``log_dir`` (open
  it with Perfetto or ``chrome://tracing``) and yields the profiler, whose
  ``key_averages()`` give the time by operation and kernel.
- :class:`StepTimer`: cheap rolling rays/sec/step-time counter for the
  training loop.
- :func:`enable_nan_checks`: autograd anomaly detection, for bug hunts.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from pathlib import Path
from typing import Deque, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit the Chrome trace is in
    ``log_dir/trace.json``. Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / TRACE_FILE))


def enable_nan_checks(enable: bool = True) -> None:
    """Make a backward pass fail loudly where a NaN is made (debug mode: slow)."""
    torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Rolling throughput meter over the last ``window`` steps."""

    def __init__(self, rays_per_step: int, window: int = 50):
        self.rays_per_step = rays_per_step
        self._times: Deque[float] = deque(maxlen=window + 1)

    def tick(self) -> None:
        self._times.append(time.perf_counter())

    @property
    def step_time(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        return (self._times[-1] - self._times[0]) / (len(self._times) - 1)

    @property
    def rays_per_sec(self) -> Optional[float]:
        dt = self.step_time
        return None if dt is None else self.rays_per_step / dt
