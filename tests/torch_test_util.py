"""Fixtures shared by the port's test files (tests/test_torch_*.py).

A file pulls a fixture in with one import, e.g.
`from torch_test_util import _two_torch_threads  # noqa: F401`.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Run the importing module's torch ops on two threads: the suite runs
    in parallel workers, and torch's default of one thread per core in
    every worker oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
