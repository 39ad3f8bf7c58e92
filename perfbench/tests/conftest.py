"""The benchmark's own tests: ``python -m pytest perfbench/tests -q``.

They run on the CPU at tiny sizes; a test that needs the card is marked
``cuda`` and skips inside its fixture when there is none."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)
