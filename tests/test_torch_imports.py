"""The port imports torch and numpy, never jax, nothing of `repro` and not
`ml_dtypes` (the card's machine has none: bf16 checkpoint leaves travel
as raw two-byte words)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro", "ml_dtypes"), f"{path}: imports {mod}"


def test_port_has_files():
    assert len(PORT_FILES) > 20


def test_subprocess_import_leaves_jax_out():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.kernels.decode_attention\n"
            "import repro_torch.kernels.ramp_head, repro_torch.models.bridge\n"
            "import repro_torch.launch.train, repro_torch.checkpoint, repro_torch.training\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
