"""The one torch thread rule of the PyTorch port's tests.

The kernels' plain PyTorch versions run many small tensors. At torch's
default thread count (every core) on a host whose CPU share is smaller
than its core count, as under ``pytest -n``, they ran about eight times
slower than at 2 threads. Every ``tests/test_torch_*.py`` module that runs
torch in the pytest process imports the fixture below, and pytest
registers it there:

    from .torch_threads import two_torch_threads  # noqa: F401

Child processes do not see the parent's fixtures; a test's child script
calls ``torch.set_num_threads(2)`` itself.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Caps torch at 2 threads for the module and restores the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
