"""Settings of the benchmark's own tests (python -m pytest vsbench/tests -q).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them, with a reason, where no card is found."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the card with python3 -m pytest vsbench/tests -m card")
    return "cuda"
