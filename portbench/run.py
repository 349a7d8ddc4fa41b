"""Run one cell of the port's benchmark once and print its result's line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, configurations, traffic mixes and
metrics are named in ``BENCHMARK.json``; ``portbench/README.md`` says how to
add each. Needs a CUDA device; exits 2 without one.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache at a fixed path inside the checkout (the
# kernels' own, build/kernels/, is fixed by the program).
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
# One process with one CPU thread a library: the window's host work is the
# program's Python and launches, and idle worker threads only take cores.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[:0] = [str(HERE), str(ROOT)]

from harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
