"""The ``one_torch_thread`` fixture of the port's test modules.

A module imports it (``from torch_threads import one_torch_thread  # noqa:
F401``) to run torch with one intra-op thread while its tests run: in the
suite's parallel workers, small CPU ops split across every core's thread
wait on each other (an 8 s test took 576 s), and one thread runs them at
their single-process speed."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
