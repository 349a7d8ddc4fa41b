"""One run of one cell: set-up, the window (timed, or traced), the check,
and the result's line.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` traces a
fixed number of the traffic's calls with ``torch.profiler`` (the device's
operations alone; kept in memory, never written), then one more call with the
host's operations too, and prints the per-layer metrics, the device's busy
and window seconds and a breakdown. Either way the run's check compares what its timed
path produced with the reference, once the window has closed, the peak memory
has been read and the program's state is freed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from typing import Dict

import torch

from harness import drivers, manifest, readers, trace
from harness.window import run_window

# Modules a run must not hold once its window has closed (whole top-level
# names): JAX and the JAX package, whose name the port's begins with.
BANNED = ("jax", "jaxlib", "flax", "nerf_and_dietnerf_tpu")
CSRC = manifest.ROOT / "nerf_and_dietnerf_tpu_torch" / "csrc"


def banned_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in BANNED})


def load_everything() -> None:
    """Import every module a run loads, the program's included."""
    import nerf_and_dietnerf_tpu_torch.ops.kernel_lib  # noqa: F401
    import nerf_and_dietnerf_tpu_torch.ops.raymarch_cuda  # noqa: F401
    import nerf_and_dietnerf_tpu_torch.parallel.render_tiles  # noqa: F401
    import nerf_and_dietnerf_tpu_torch.train.trainer  # noqa: F401
    import torch.profiler  # noqa: F401
    for m in manifest.load()["per_layer"]:
        readers.load(m["name"])


def run_cell(cfg: Dict, traffic: Dict, limits: Dict, e2e: list, per_layer: list, seed: int,
             seconds: float, traced: bool, device, t0: float) -> Dict:
    """The result of one run (the keys of the printed line)."""
    from nerf_and_dietnerf_tpu_torch.ops import kernel_lib

    device = torch.device(device)
    cuda = device.type == "cuda"
    drv = drivers.KINDS[traffic["kind"]](cfg, traffic, seed, device)
    drv.set_up()
    drivers.sync(device)
    setup_s = time.perf_counter() - t0
    kernel_lib.reset_launch_counts()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        # The device alone over the traced window, so that the host's part of
        # the profiler does not slow it; then one call with the host's
        # operations too, to name what the host did in the device's gaps.
        kind, act = ("CUDA", ProfilerActivity.CUDA) if cuda else ("CPU", ProfilerActivity.CPU)
        with profile(activities=[act]) as prof:
            win = run_window(drv.call, seconds, max_calls=traffic["trace_calls"])
        tr = trace.read(prof, kind)
        with profile(activities=list({ProfilerActivity.CPU, act})) as prof:
            extra = run_window(drv.call, seconds, max_calls=1, first=len(win.calls))
        tr.idle_by_host = trace.read(prof, kind).idle_by_host
        del prof
    else:
        win = run_window(drv.call, seconds)
        extra = None
    if cuda:
        # The launch counters this configuration's path moves in this kind
        # of traffic: the configuration's file names them.
        idle = [k for k in cfg["launch_counters"][traffic["kind"]] if kernel_lib.LAUNCHES[k] == 0]
        if idle:
            raise RuntimeError(f"the window launched none of the kernels {idle}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    work = drv.work(win)
    e2e_values = drv.end_to_end(win)
    drv.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = drv.check()
    # A number the cell's limits do not name is not compared (PERF.md says why).
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    attempted = win.units + (extra.units if extra else 0)
    failed = win.failed + (extra.failed if extra else 0)
    correct = (failed == 0 and attempted > 0 and
               all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))

    metrics = {}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if traced:
        ctx = readers.Context(tr, work, drv.dims, trace.hand_kernels(CSRC))
        for m in per_layer:
            value = readers.load(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out.update(metrics=metrics, device=dev, breakdown=tr.breakdown())
    else:
        e2e_values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": e2e_values[m["name"]], "unit": m["unit"]}
        out.update(metrics=metrics, device=dev,
                   window={"seconds": win.seconds, "call_s": win.calls})
    out["checks"] = checks
    return out


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    # The configurations state float32 products without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = run_cell(manifest.config(man, cell["config"]), manifest.traffic(cell["traffic"]),
                   manifest.limits(cell["name"]), manifest.end_to_end(man, cell["name"]),
                   manifest.per_layer(man, cell["name"]), args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), t0)
    banned = banned_modules()
    if banned:
        print(f"the run loaded JAX or the JAX package: {banned}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_finite(out)))
    return 0


def _finite(x):
    """``x`` with every float that is not finite made null, so the line is JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x
