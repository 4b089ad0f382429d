"""One intra-op thread for a whole test module (the torch side of a port
test; the reference's XLA pool keeps its own threads).

The tiny models gain nothing from more threads, and under several test
workers on few cores, or beside the reference's thread pool in the same
process, torch's idle threads' waits dominate (a 3 ms (8 × 32) @ (32 × 32)
matmul). A module imports the fixture to use it::

    from _torch_threads import one_thread_module  # noqa: F401
"""
from __future__ import annotations

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread_module():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
