"""The port's tests run torch on one thread.

The suite's workers share the host's cores, and the tensors of these tests
are small: torch's default of one thread per core in every worker spends
more time contending for the cores than computing. A test file imports the
fixture, which then holds for every test in it:

    from tests.torch_threads import one_torch_thread  # noqa: F401

Ranks started by ``parallel.spawn`` are fresh processes and keep
``parallel/mesh.py``'s own rule.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for the module's tests; the old count after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
