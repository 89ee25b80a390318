"""An autouse fixture for the port's test modules: one torch thread.

The tests hold the port to the reference at small sizes, where torch's
intra-op threads gain nothing; under ``pytest-xdist`` every worker's pool
would spin on the same cores as the others' work.  A test module takes it
with ``from torch_threads import one_torch_thread  # noqa: F401``; the
count is restored when the module's tests are done.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
