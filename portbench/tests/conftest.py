"""The benchmark's own tests: ``python -m pytest portbench/tests`` on the CPU
(the card's tests skip), ``python -m pytest -m gpu portbench/tests`` on the
card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")
    import torch

    # The kernels' plain versions run in every worker; one thread each keeps
    # several workers from crowding the cores.
    torch.set_num_threads(1)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is available."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
