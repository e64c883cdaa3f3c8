"""The benchmark tests' `cuda` marker and the fixture that skips a test
needing the card where there is none."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_card():
    """Skips the test where no CUDA card is present (decided here, not at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs on the card")
