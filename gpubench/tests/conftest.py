"""Tests of the benchmark harness.

    python -m pytest gpubench/tests -q -p no:randomly            # CPU
    python -m pytest gpubench/tests -q -p no:randomly -m card    # on a card

The tests marked ``card`` run the harness at a cell's own size on a CUDA
device; they decide inside the test whether one is there and skip
without it.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def small_cell(name, n=48, block_size=16, batch=None, **traffic):
    """Cell ``name`` of BENCHMARK.json with its traffic cut to a size a
    CPU test holds; its configuration and limits as they are."""
    from gpubench import spec

    cell = spec.load_cell(name)
    cell.traffic = dict(cell.traffic, n=n, block_size=block_size,
                        batch=min(cell.batch, batch or 3), **traffic)
    return cell
