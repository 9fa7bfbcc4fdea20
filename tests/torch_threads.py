"""torch's CPU thread count for the port's test modules.

The suite runs its files on several pytest-xdist workers at once, each of
which would otherwise start one torch thread per core; the port's tests
import this module's autouse fixture so that each of their modules runs
with THREADS torch threads and the workers do not oversubscribe the host.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(before)
