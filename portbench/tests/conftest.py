"""The benchmark's own tests.  ``card``: tests that need the H100 (its
CUDA kernels have no CPU form); they skip here, deciding inside the
fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.cuda.get_device_name(0)
