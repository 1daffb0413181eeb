"""An autouse fixture for the port's CPU parity tests: one PyTorch
intra-op thread while a test module runs. The suite runs several pytest
workers on a few cores, and on the small tensors of these tests PyTorch's
default thread pool mostly spins: the LiDAR parity files took 6m02s of
CPU on two workers with it and 3m19s without, in about the same wall
time, and the spinning slows the other workers' files. Import it into a
test module:

    from torch_port_threads import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
