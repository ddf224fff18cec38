"""pytest settings of the benchmark's own tests (``pytest bench/tests``):
the repository root and ``src`` on the path, and the ``card`` marker for
tests that need a CUDA device, which skip without one (decided in the
``card`` fixture, never while a module is imported)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    return torch.device("cuda")
