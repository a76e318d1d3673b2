"""The thread count of torch's CPU operators in the PyTorch port's tests.

The tier-1 command runs the tests in six processes on the host's cores;
each torch process would otherwise take a thread per core, and its
operators' threads then spin waiting for each other on oversubscribed
cores (a test whose work takes 5 s alone took 110 s beside five busy
processes, 22 s with 2 threads).  Every port test module imports the
fixture below, which runs the module's tests on at most ``THREADS``
threads and restores the count after it; the work and the checks are the
same."""

import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)
