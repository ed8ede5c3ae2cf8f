"""The port's CPU tests run thousands of small torch ops per case, in
several pytest-xdist workers at once. Each test file imports
``_one_thread``: one intra-op thread per worker while its tests run, so
the workers' spinning thread pools do not oversubscribe the cores (with
eight threads per worker, a case that takes a third of a second alone
took over a minute beside five other workers)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
