"""Test settings of the port's benchmark (``python -m pytest port_bench/tests``
from the repository root). Tests marked ``card`` need an NVIDIA card: each
decides inside the test, through the ``cuda`` fixture, whether one is there,
and skips without it."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
for path in (os.path.dirname(HERE), HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (TF32 and the kernels exist only "
                    "there)")
    return "cuda"
