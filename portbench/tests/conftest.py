"""The benchmark's own tests (run them with
`python -m pytest portbench/tests` from the root of the checkout).
Tests that need the card carry the `cuda` marker and skip without one,
deciding inside the test."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
