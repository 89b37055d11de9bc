"""Import ``torch_threads`` into a port test file (``from _torch_threads
import torch_threads  # noqa: F401``): a module-scoped autouse fixture
that holds torch's intra-op threads at ``TORCH_THREADS`` while the file
runs and restores the count after it.

The suite runs as six pytest workers on eight cores.  Left at its
default, each worker's torch starts one OpenMP thread a core, and the
workers' threads spin against each other: six of the heaviest port files
took 537 s together under ``-n 6 --dist loadfile`` with the default
count, 94 s with one thread and 60 s with two (on 8 CPU cores)."""
import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(prev)
