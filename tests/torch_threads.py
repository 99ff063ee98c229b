"""The port's test modules' thread cap, imported by each of them."""

import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the importing module, torch's and numpy's
    BLAS, restored after it: the tier-1 suite runs six workers on the
    host's cores, where threads that wait for work spinning slow them
    all (torch's default of a thread a core made the pix2pix CLI runs 30
    times longer; OpenBLAS's made OPQ's SVD most of the ANN probes' tiny
    stages)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(2, user_api="blas"):
        yield
    torch.set_num_threads(n)
