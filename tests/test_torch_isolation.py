"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and
each host-side module the port copies from the reference equals its
reference file once ``repro.`` is rewritten to ``repro_torch.``."""
import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

COPIED = ([f"core/{m}.py" for m in ("request", "kvc", "ordering",
                                     "pipelining", "predictor", "costmodel",
                                     "pressure", "scheduler")]
          + ["models/config.py", "configs/__init__.py"]
          + [f"configs/{p.name}"
             for p in sorted((REF / "configs").glob("*.py"))
             if p.name != "__init__.py"])


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value
                elif isinstance(arg, ast.JoinedStr):
                    yield "".join(v.value for v in arg.values
                                  if isinstance(v, ast.Constant))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_reference(rel):
    want = (REF / rel).read_text().replace("repro.", "repro_torch.")
    assert (PORT / rel).read_text() == want, \
        f"{rel} drifted from src/repro/{rel}"


def test_every_reference_config_is_copied():
    ref = {p.name for p in (REF / "configs").glob("*.py")}
    port = {p.name for p in (PORT / "configs").glob("*.py")}
    assert ref == port and len(ref) == 12
