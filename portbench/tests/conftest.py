"""Shared set-up of the benchmark's tests: the repository root on the path,
the `card` marker, and small copies of the cells for the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: A grid the CPU runs a cell on in seconds.
SMALL = {"nx": 12, "ny": 10, "nz": 8}
#: The encoding's finest level on the CPU: its coarse levels hashed and its
#: fine ones dense, as on the card, in a few MB of parameters.
SMALL_MAX_RESOLUTION = 32
CELLS = ("mlp_train_256", "ngp_train_256", "mlp_serve_256", "ngp_fit_256")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (runs on the card, skips elsewhere)")


def small_cell(name: str, **grid):
    """The cell `name` of BENCHMARK.json on a small grid (an encoding's
    finest level cut to SMALL_MAX_RESOLUTION)."""
    from portbench.core import specs

    cell = specs.load_cell(ROOT, name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["grid"].update(SMALL, **grid)
    enc = cell.config.get("encoding")
    if enc is not None:
        enc["max_resolution"] = min(enc["max_resolution"], SMALL_MAX_RESOLUTION)
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
