"""The benchmark's own tests: ``python -m pytest ivmbench/tests -q``.
Tests marked ``cuda`` need the card and skip without one (each decides
in its fixture, never while the module is imported)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
