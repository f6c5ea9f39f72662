"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker, and the fixture that decides, at
run time, whether a CUDA device is present."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
