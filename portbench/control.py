"""Readings that set a cell's correctness limits, for many seeds in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        --sides program control fault:half_batch --out chiprun_out/readings.jsonl

Sides:
- ``program``: the program's readings, as a run's check takes them (the
  render cell renders ``check_frames`` frames for it);
- ``control``: the reference one precision below the configuration's
  (``reference/precision.py``) in the program's place, against the reference;
- ``fault:<name>``: the reference with a fault planted (the kind's
  ``faults``) in the program's place, against the reference;
- ``self``: the reference against itself (its own run-to-run noise).

Each reading is one JSON line: cell, seed, side, the compared numbers and
the diagnostics they were chosen from. The benchmark's
runs never run this; it is how the limits in ``portbench/limits/`` were read.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import torch  # noqa: E402

from harness import drivers, manifest  # noqa: E402
from harness.window import run_window  # noqa: E402


def readings(cell_name: str, seeds, sides, device, cfg=None, traffic=None):
    """Yield ``{"cell", "seed", "side", "numbers", "seconds"}`` for each seed
    and side."""
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    cfg = cfg or manifest.config(man, cell["config"])
    traffic = traffic or manifest.traffic(cell["traffic"])
    for seed in seeds:
        t0 = time.perf_counter()
        drv = drivers.KINDS[traffic["kind"]](cfg, traffic, seed, device)
        drv.set_up()
        if "program" in sides and traffic["kind"] == "render":
            run_window(drv.call, 0.0, max_calls=traffic["check_frames"])
        drv.release()
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        setup_s = time.perf_counter() - t0
        for side in sides:
            t = time.perf_counter()
            pair = drv.pair(side)
            yield {"cell": cell_name, "seed": seed, "side": side, "numbers": drv.numbers(*pair),
                   "diagnostics": drv.diagnostics(*pair), "seconds": time.perf_counter() - t,
                   "setup_s": setup_s}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+", default=["program", "control"])
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = open(args.out, "a") if args.out else None
    for r in readings(args.workload, args.seeds, args.sides, torch.device("cuda", 0)):
        line = json.dumps(r)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
