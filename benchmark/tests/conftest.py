"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from the
repository root. Tests marked ``cuda`` run on a card only and skip here."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors on many threads are slower, and test workers share cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
