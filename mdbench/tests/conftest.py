"""The benchmark's own tests: ``python -m pytest mdbench/tests`` from the
root of the checkout.  They run on the CPU through the program's plain
versions, at sizes a test run holds; those marked ``cuda`` need a card
and skip without one (decided in the ``card`` fixture)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
