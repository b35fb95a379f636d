"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests that need a CUDA card carry the ``cuda`` marker and skip without
one, deciding inside the test."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
