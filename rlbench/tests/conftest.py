"""The benchmark's own tests.  Run them from the repository's root:

    python -m pytest -q rlbench/tests

Tests marked ``card`` need a CUDA card; the ``card`` fixture decides at
run time and skips them without one.  They run on the chip with the same
command.
"""
import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark's chip tests)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test process, as the repository's tests
    run."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
