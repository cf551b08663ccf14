"""One torch thread for a CPU test module.

The suite runs several pytest workers on the machine's cores, and torch's
intra-op pool in each of them (a thread per core) makes them contend: a
module of small CPU tensors runs many times slower beside the others than
alone. A test module imports `one_torch_thread` to run on one thread; the
count is restored when the module ends.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
