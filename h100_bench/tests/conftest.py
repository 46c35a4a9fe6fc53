"""The benchmark's own tests: on the CPU here, the ``cuda`` ones on the card.

    python -m pytest h100_bench/tests -q                 # the CPU tests
    python -m pytest h100_bench/tests -m cuda -q         # on the card

A test that needs a card takes the ``card`` fixture, which skips where
torch sees none (decided in the fixture, never at import).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)
