"""pytest settings of the benchmark's own tests (``benchmark/tests/``)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; decides inside the test and "
        "skips without one")
