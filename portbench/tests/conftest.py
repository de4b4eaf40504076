"""The benchmark's tests.  ``card`` marks a test that needs a CUDA card: the
``card`` fixture skips it where there is none (decided inside the test,
never while a module is imported).  On the card:
``python3 -m pytest portbench/tests -q``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
