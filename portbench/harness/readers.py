"""What a per-layer metric's reader is handed, and the arithmetic the readers
share. Each metric is a file ``portbench/metrics/<name>.py`` whose
``read(ctx)`` returns its value, or None where its cell's trace holds nothing
for it to read (the harness then leaves it out of the line).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Dict, List, Optional

from harness import counts
from harness.trace import Trace

METRICS_DIR = Path(__file__).resolve().parents[1] / "metrics"


@dataclasses.dataclass
class Context:
    trace: Trace
    work: Dict               # the traced window's units, rows and launches
    dims: Dict               # the configuration's MLP widths
    hand_kernels: List[str]  # the program's own CUDA kernels by name


def load(name: str):
    """The ``read`` function of the metric ``name``."""
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def idle_percent(ctx: Context) -> float:
    return 100.0 * ctx.trace.idle_share


def mfu_percent(ctx: Context, passes: int, dtype: str) -> Optional[float]:
    """The window's model operations over the card's peak: ``passes`` is 1
    for a forward, 3 for a forward and its backward."""
    rows = ctx.work.get("rows_fwd")
    if not rows:
        return None
    flops = rows * counts.forward_flops(ctx.dims) * passes
    return 100.0 * flops / ctx.trace.window_s / counts.PEAK_FLOPS[dtype]


def roofline_percent(ctx: Context, direction: str, symbols, dtype: str) -> Optional[float]:
    """The bound time of the window's MLP ``direction`` ("fwd" or "bwd")
    over the device time of the kernels named ``symbols``."""
    seconds, n = ctx.trace.seconds_of(symbols)
    rows = ctx.work.get(f"rows_{direction}")
    if not seconds or not n or not rows:
        return None
    launches = ctx.work["launches"]
    if direction == "fwd":
        flops = rows * counts.forward_flops(ctx.dims)
        nbytes = counts.forward_bytes(ctx.dims, rows, launches, dtype)
    else:
        flops = rows * counts.backward_flops(ctx.dims)
        nbytes = counts.backward_bytes(ctx.dims, rows, launches, dtype)
    return 100.0 * counts.bound_seconds(flops, nbytes, dtype) / seconds


def outside_percent(ctx: Context) -> Optional[float]:
    """The share of the device operations' time spent outside the program's
    own kernels."""
    total = sum(s for s, _ in ctx.trace.by_name.values())
    hand, n = ctx.trace.seconds_of(ctx.hand_kernels)
    if not total or not n:
        return None
    return 100.0 * (total - hand) / total
