"""One torch intra-op thread for a test module of the port.

The suite runs about one xdist worker per core, and torch's default pool
of a thread per core then spins against the other workers: on an 8-core
machine, six concurrent runs of ``test_torch_dense_steps.py``'s
trajectory tests took 579 s with the default pool and 82 s with one
thread. The bits a test compares do not depend on it: the port's CPU
paths compared bit for bit are elementwise, sorts or gathers, and both
sides of a port-to-port comparison run alike.

A module takes it with ``from test_torch_threads import
one_torch_thread``.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
