"""Reading a profiler trace: device busy time, idle share, time by operation,
and what the host was doing while the device waited.

``device_window`` is the method of the port's smoke script (``chip_smoke.py``,
``_device_window``): the device operations' intervals merged where they
overlap, their union the busy time, the span from the first to the last the
window.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

TOP = 10            # entries of each breakdown list
GAPS_NAMED = 500  # longest idle gaps attributed to a host operation


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: int                       # device operations in the window
    by_name: Dict[str, Tuple[float, int]]  # device seconds and count by operation name
    idle_by_host: Dict[str, float]        # idle seconds by the host operation under the gap

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def seconds_of(self, symbols) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name holds one
        of the kernel ``symbols`` as a whole word."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
        hits = [(s, c) for name, (s, c) in self.by_name.items() if pat.search(name)]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:160], s] for name, (s, _) in ops],
                "idle_gaps": [[name[:160], s] for name, s in gaps]}


def _on(kind: str):
    return lambda evt: str(evt.device_type).endswith(kind)


def _device_us(evt) -> float:
    if str(evt.device_type).endswith("CPU"):
        return float(evt.self_cpu_time_total)
    return float(getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0.0)))


def read(prof, kind: str = "CUDA") -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``: its
    operations on devices of ``kind`` ("CUDA"; "CPU" reads a CPU run's
    operations as the device's, for the tests)."""
    _on_device = _on(kind)
    events = prof.events()
    averages = [a for a in prof.key_averages() if _on_device(a)]
    total_us = sum(_device_us(a) for a in averages)
    spans = sorted((e.time_range.start, e.time_range.end) for e in events if _on_device(e))
    if not spans or total_us <= 0:
        raise RuntimeError(f"the profiler recorded no device time ({len(spans)} device "
                           f"events, {total_us} us)")
    # The events' clock unit differs between PyTorch versions: scale it so
    # that the intervals add up to the averages' device time, in microseconds
    # (CPU operations nest, so their clock is taken as it is).
    unit = 1.0 if kind == "CPU" else total_us / sum(end - start for start, end in spans)
    merged = [list(spans[0])]
    for start, end in spans[1:]:
        if start > merged[-1][1]:
            merged.append([start, end])
        else:
            merged[-1][1] = max(merged[-1][1], end)
    busy = sum(end - start for start, end in merged) * unit
    window = (spans[-1][1] - spans[0][0]) * unit
    by_name = {a.key: (_device_us(a) / 1e6, int(a.count)) for a in averages}
    return Trace(window / 1e6, busy / 1e6, len(spans), by_name,
                 _idle_by_host([e for e in events if not _on_device(e)], merged, unit))


def _idle_by_host(host, merged, unit) -> Dict[str, float]:
    """The longest gaps between device operations, each given to the
    innermost host operation running at its start."""
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1]) for i in range(len(merged) - 1)]
    gaps = sorted(gaps, reverse=True)[:GAPS_NAMED]
    if not gaps or not host:
        return {}
    starts = np.array([e.time_range.start for e in host], np.float64)
    ends = np.array([e.time_range.end for e in host], np.float64)
    length = ends - starts
    out: Dict[str, float] = {}
    for gap, at in gaps:
        under = np.nonzero((starts <= at) & (ends > at))[0]
        name = host[under[np.argmin(length[under])]].name if len(under) else "(no host operation)"
        out[name] = out.get(name, 0.0) + gap * unit / 1e6
    return out


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")


def hand_kernels(csrc: Path) -> List[str]:
    """The names of the program's own CUDA kernels: every ``__global__``
    function of its sources."""
    names = set()
    for f in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(f.read_text()))
    return sorted(names)
