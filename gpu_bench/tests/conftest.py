"""The benchmark's own tests: ``python -m pytest gpu_bench/tests -q`` from the
root of the repository.  Tests that need a card are marked ``cuda`` and skip
inside the test where there is none."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device; skips inside the test where there is none")
