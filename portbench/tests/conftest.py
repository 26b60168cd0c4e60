"""The harness's own tests: a small world on the CPU through the port's
plain paths. Tests that need a CUDA card carry the ``gpu`` marker and skip
without one (the card is looked for inside the test, never at import)."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (runs the cell at its own size)")
