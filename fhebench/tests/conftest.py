"""The benchmark's own tests: `python -m pytest fhebench/tests -q` on the
CPU; the tests marked `card` run the control and the faults at the cells'
own sizes and skip without a CUDA card, which a fixture decides, never an
import."""

import os
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control runs at the cells' own sizes "
                    "on the card")
