"""Fixtures of the benchmark's own tests."""

import pytest


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
