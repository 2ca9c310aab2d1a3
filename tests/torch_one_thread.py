"""A fixture that runs torch on one thread for the duration of a test.

The suite runs several test processes on the machine's cores; the ops of
the training, dry-run and s2d tests are small, and torch's thread pool
there waits on threads that the other processes hold.  A test module
takes it with ``from tests.torch_one_thread import oneTorchThread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def oneTorchThread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
