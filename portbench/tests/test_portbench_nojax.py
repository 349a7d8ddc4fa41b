"""Nothing a run loads is JAX or the JAX package (whole top-level names: the
port's own name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

from harness import cli

BENCH = Path(__file__).resolve().parents[1]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import harness.cli as c; c.load_everything(); import control; "
            "print(repr(c.banned_modules())); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH.parent)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    banned, loaded = out.splitlines()[:2]
    assert banned == "[]"
    assert "'nerf_and_dietnerf_tpu_torch'" in loaded


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nerf_and_dietnerf_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert cli.banned_modules() == ["jaxlib.xla_client"]
