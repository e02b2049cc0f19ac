"""Fixtures of the benchmark's tests."""
import pytest


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
