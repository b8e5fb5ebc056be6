"""A fixture for the port's test modules: PyTorch single-threaded while the
module runs. On the CPU, in a process that has run XLA, PyTorch's first
multithreaded sqrt over more than a few thousand elements has returned
results off by ~1e-5 relative in one or two threads' blocks in some runs
(tests/test_torch_brute.py); on one thread it gives its usual results every
run, and test processes running side by side do not oversubscribe the
cores with PyTorch's thread pools. A module takes it with

    from torch_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
