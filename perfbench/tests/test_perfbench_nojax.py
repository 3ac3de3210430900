"""Nothing under perfbench/ imports JAX or the JAX package (top-level
names compared whole, so ``repro_torch`` passes and ``repro`` does not),
nothing names the JAX package's benchmark folder, and the reference
imports nothing of the program."""
import ast
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402

SOURCES = sorted(BENCH.rglob("*.py"))
OTHER = "bench" "marks/"          # the JAX package's benchmark folder


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert run.forbidden_modules(_imports(path)) == []
    assert OTHER not in path.read_text()


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert tops <= {"__future__", "contextlib", "numpy", "torch"}


def test_top_level_names_compared_whole():
    assert run.forbidden_modules(["repro_torch", "repro_torch.models.lm",
                                  "jaxtyping", "reproduce"]) == []
    assert run.forbidden_modules(["repro.core", "jax.numpy", "jaxlib",
                                  "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]
