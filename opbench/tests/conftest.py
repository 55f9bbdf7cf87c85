"""The benchmark's own tests: ``python -m pytest opbench/tests`` from the
checkout's root (the repository's ``pytest`` run collects ``tests/``
only).  Tests marked ``gpu`` need a CUDA card and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
