"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests marked ``card`` need a CUDA card; each decides inside its ``card``
fixture whether one is present and skips with the reason where it is not.
On the card: ``python -m pytest benchmark/tests -m card``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs on a CUDA card only")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs there only")
    return torch.device("cuda")
