"""Settings of the benchmark's own tests (run from the repository root:
``python -m pytest benchmark/tests``).  Tests that need the card carry the
``card`` marker and decide inside the test whether a card is there."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
