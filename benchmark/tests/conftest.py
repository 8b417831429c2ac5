"""The benchmark's own tests (CPU): ``python -m pytest benchmark/tests``.

They drive the harness with the port's plain-torch twins on tiny frames.
A test that needs the card is marked ``gpu`` and decides inside a fixture
whether a card is there."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
