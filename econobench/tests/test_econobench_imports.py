"""The benchmark imports neither JAX nor the JAX package, names compared
whole (``repro_torch`` begins with ``repro``); the references import
nothing of the port either."""
import ast
from pathlib import Path

import pytest

from econobench import harness

BENCH = Path(harness.__file__).resolve().parent


def _roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not set(_roots(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_stand_alone(path):
    assert set(_roots(path)) <= {"__future__", "typing", "torch", "math",
                                 "numpy"}


def test_forbidden_modules_compares_whole_names():
    mods = ["repro_torch", "repro_torch.serving.engine", "reprox", "numpy",
            "jaxtyping"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["repro", "jax.numpy",
                                             "flax.linen"]) == [
        "flax.linen", "jax.numpy", "repro"]


def test_a_cpu_run_of_the_harness_loads_no_jax(one_thread):
    import sys
    from conftest import tiny
    cell = tiny("nemo12b.chat")
    harness.serve(cell, 5, 0.5, False, "cpu")
    assert harness.forbidden_modules(list(sys.modules)) == []
