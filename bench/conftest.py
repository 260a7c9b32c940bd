"""pytest settings of the benchmark's own tests: the ``gpu`` marker (a
test that needs a CUDA card skips without one) and the paths that make
``bench`` and the port importable."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one; run with -m gpu on the card)")


@pytest.fixture(autouse=True)
def _few_threads():
    """Two CPU threads a test: the suite runs several workers at once."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA card (decided here, never at
    import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
