"""The benchmark's CPU tests run tiny models whose ops gain nothing from
many threads; one intra-op thread a test keeps them from crowding the
other test workers of a parallel run."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
