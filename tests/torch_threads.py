"""One torch intra-op thread for each of the port's test modules (pytest
does not collect this module; each ``tests/test_torch_*.py`` imports the
fixture, which is autouse).

The suite runs several pytest workers on the host's cores.  With torch's
default of a thread per core in every worker, the workers' OpenMP teams
spin against each other and a test can take ten times as long as it does
alone; with one thread each, the workers share the cores."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
