"""Test settings of the port's benchmark: the harness's import paths and the
marker of the tests that need a CUDA card (they skip inside the test, here
on the CPU)."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
