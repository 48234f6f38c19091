"""The benchmark's own tests, on the CPU at the smoke configurations:

    python -m pytest -q perfbench/tests

(the repository's test run collects ``tests/`` only).  A test that needs
the card asks for the ``card`` fixture, which skips without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
