"""The benchmark's own tests: CPU tests of the harness, and tests marked
``card`` that need a CUDA card and skip without one.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
