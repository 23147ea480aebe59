"""pytest settings of the benchmark's own tests (benchmark/pytest.ini holds
the marker): the checkout root, the benchmark and its reference on the path,
and the `cuda` fixture that skips a card test where there is no card."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for _p in (HERE.parent, HERE, HERE / "reference"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is visible (decided here, never
    while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip with `python -m pytest "
                    "benchmark/tests -m chip`")
    return torch.device("cuda")
