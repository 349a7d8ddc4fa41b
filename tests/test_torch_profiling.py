"""Port vs JAX package: ``utils/profiling.py``."""

import json

import torch

from nerf_and_dietnerf_tpu.utils import profiling as jprof
from nerf_and_dietnerf_tpu_torch.utils import profiling as tprof


def test_step_timer_gives_the_jax_class_numbers(monkeypatch):
    ticks = [10.0, 10.5, 11.5, 13.0, 13.25]
    seen = []
    for cls in (jprof.StepTimer, tprof.StepTimer):
        clock = iter(ticks)  # both modules read the one ``time.perf_counter``
        monkeypatch.setattr(jprof.time, "perf_counter", lambda: next(clock))
        timer = cls(rays_per_step=4096, window=3)
        assert timer.step_time is None and timer.rays_per_sec is None
        got = []
        for _ in ticks:
            timer.tick()
            got.append((timer.step_time, timer.rays_per_sec))
        seen.append(got)
    assert seen[0] == seen[1]
    assert seen[1][0] == (None, None) and seen[1][1] == (0.5, 8192.0)
    # The window keeps the last 3 steps: (13.25 - 10.5) / 3.
    assert seen[1][-1][0] == (13.25 - 10.5) / 3
    assert seen[1][-1][1] == 4096 / seen[1][-1][0]


def test_trace_writes_a_chrome_trace_and_yields_the_profiler(tmp_path):
    log_dir = tmp_path / "traces" / "run0"
    with tprof.trace(str(log_dir)) as prof:
        a = torch.ones((64, 64))
        (a @ a).sum().item()
    path = log_dir / tprof.TRACE_FILE
    assert path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    names = [k.key for k in prof.key_averages()]
    assert any("mm" in n for n in names)


def test_enable_nan_checks_turns_anomaly_detection_on_and_off():
    assert not torch.is_anomaly_enabled()
    tprof.enable_nan_checks()
    try:
        assert torch.is_anomaly_enabled()
    finally:
        tprof.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
