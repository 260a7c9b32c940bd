"""Nothing under bench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not FORBIDDEN & set(_top_names(path))


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = set(_top_names(path))
    assert "repro_torch" not in names and not FORBIDDEN & names


def test_whole_names_are_compared():
    from bench.harness import FORBIDDEN as RUNTIME

    assert set(RUNTIME) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """The modules a run loads (the harness, the reference, the port's
    serving path) bring in no JAX: the harness's own check reads nothing."""
    import subprocess
    import sys

    root = BENCH.parent
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from bench import harness, check, roofline, tracing, weights; "
            "import repro_torch.serving, repro_torch.models, repro_torch.core, "
            "repro_torch.configs, repro_torch.kernels.build; "
            "print(harness.forbidden_modules())" % (str(root / "src"), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
