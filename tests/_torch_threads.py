"""Shared fixture for the port's test files (tests/test_torch_*.py).

The suite runs several pytest workers per host beside JAX's own thread
pools; torch's default of one intra-op thread per core oversubscribes
them (measured: the port's tests run faster on two threads). Each file
imports `two_torch_threads`, which pins torch to two threads for the
file and restores the setting after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
