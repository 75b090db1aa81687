"""The card fixture: decided when a test asks for it, never at import."""

import pytest


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda:0")
