"""A fixture for the port's CPU tests: one PyTorch intra-op thread.

The port's CPU tests run many small tensor operations.  With several test
processes sharing the cores, each operation spread over every core waits
for its slowest thread, and a run that takes a second alone takes minutes.
A test module imports the fixture to hold its torch work to one thread.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
