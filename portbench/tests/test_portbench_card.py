"""On the card: every cell runs, untraced and traced, and comes out correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from harness import manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483999", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                         capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_without_a_card_a_run_exits_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
