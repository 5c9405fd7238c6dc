"""Tests of the benchmark's own code. CPU tests run anywhere; a test that
needs the card is marked ``cuda`` and skips inside its fixture when torch
sees no CUDA device. Run from the repository's root:
``python -m pytest benchmark/tests -q``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("torch sees no CUDA device")
    return torch.device("cuda", 0)
