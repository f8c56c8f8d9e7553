"""A fixture for the port's CPU test files whose tensors are tiny: import
``one_torch_thread`` into a test module to run it with one torch intra-op
thread, so that the many small ops do not spin against the other test
workers' threads. A file imports it only where its results stay within
its stated tolerances under one thread as under the default pool; the
thread count changes the order of a matmul's sums, so the last bits of
its results may move."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
