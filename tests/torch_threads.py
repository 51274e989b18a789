"""One intra-op thread for the port's CPU test modules.

The suite runs in several xdist workers on one machine's cores, and each
worker's PyTorch would otherwise start an intra-op pool (and MKL's) as
wide as the machine: the pools oversubscribe the cores and spin-wait.  A
test module that imports :func:`one_thread` runs its tests with one
intra-op thread and gives the worker its count back after them; spawned
ranks (``torch_ranks.run_ranks``) and the dry runs' subprocesses take one
thread of their own.  ``tests/test_torch_train.py`` keeps the worker's
count: its qwen2.5-32b step lands within its parameter bound with the
machine-wide pool and 1.07e-5 off (against 1e-5) with one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
