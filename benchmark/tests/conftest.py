"""The benchmark's tests run from the checkout's root; each worker keeps to
one thread, and a test that needs the card asks for it in a fixture."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures only there")
    return torch.device("cuda", 0)
