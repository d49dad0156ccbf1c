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
                                     "pressure", "scheduler", "metrics",
                                     "simulator", "traces", "baselines",
                                     "registry")]
          + [f"obs/{m}.py" for m in ("registry", "sampler")]
          + [f"cluster/{m}.py" for m in ("transport", "autoscale", "base",
                                         "router", "hedge", "sim",
                                         "__init__")]
          + ["models/config.py", "configs/__init__.py", "training/data.py"]
          + [f"configs/{p.name}"
             for p in sorted((REF / "configs").glob("*.py"))
             if p.name != "__init__.py"])
# copied but for the named top-level definitions (``__doc__`` the module
# docstring, a constant by its name)
COPIED_EXCEPT = {"cluster/faults.py": {"corrupt_payload"},
                 "launch/analytic.py": {"__doc__", "PEAK_FLOPS", "HBM_BW",
                                        "LINK_BW", "CHIPS"}}
# copied but for the named top-level definitions, which the port drops
# (with the module docstring, the imports and ``__all__`` that name them);
# ``obs/__init__.py`` is the port's own: it adds the serving loop's spans
COPIED_WITHOUT = {"obs/exporters.py": {"request_trace_events",
                                       "write_chrome_trace"}}


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


def _definitions(text: str):
    """Source text of each top-level definition, a class's methods keyed
    ``Class.method`` (decorators and inner comments included); an
    assignment to one name is keyed by the name, the module docstring by
    ``__doc__``."""
    lines = text.splitlines(keepends=True)

    def src(node):
        first = min([node.lineno] + [d.lineno for d in
                                      getattr(node, "decorator_list", [])])
        return "".join(lines[first - 1:node.end_lineno])

    out = {}
    for i, node in enumerate(ast.parse(text).body):
        name = getattr(node, "name", None) or f"<statement {i}>"
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        elif i == 0 and isinstance(node, ast.Expr) \
                and isinstance(node.value, ast.Constant):
            name = "__doc__"
        out[name] = src(node)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{name}.{sub.name}"] = src(sub)
    return out


@pytest.mark.parametrize("rel", sorted(COPIED_EXCEPT))
def test_copied_module_equals_reference_but_for_named_definitions(rel):
    """Every top-level definition (and method) equals the reference's but
    the exempt ones; with the exempt methods swapped back, the whole file
    equals the reference, comments between definitions included."""
    ref_text = (REF / rel).read_text().replace("repro.", "repro_torch.")
    port_text = (PORT / rel).read_text()
    want, got = _definitions(ref_text), _definitions(port_text)
    assert set(got) == set(want), f"{rel}: definitions differ"
    exempt = {n for n in want if n.split(".")[-1] in COPIED_EXCEPT[rel]}
    assert exempt, f"{rel}: no definition named {COPIED_EXCEPT[rel]}"
    drifted = sorted(n for n in want if got[n] != want[n]
                     and n not in exempt
                     and not any(e.startswith(n + ".") for e in exempt))
    assert not drifted, f"{rel} drifted from src/repro/{rel}: {drifted}"
    for n in exempt:
        port_text = port_text.replace(got[n], want[n])
    assert port_text == ref_text, f"{rel} drifted outside its definitions"


@pytest.mark.parametrize("rel", sorted(COPIED_WITHOUT))
def test_copied_module_equals_reference_but_for_dropped_definitions(rel):
    """Every top-level definition (and method) the port keeps equals the
    reference's, but the module docstring, the imports and ``__all__``,
    which lose the dropped names and nothing else."""
    ref_text = (REF / rel).read_text().replace("repro.", "repro_torch.")
    port_text = (PORT / rel).read_text()
    want, got = _definitions(ref_text), _definitions(port_text)
    dropped = COPIED_WITHOUT[rel]
    assert dropped <= set(want), f"{rel}: no definition named {dropped}"
    assert set(got) == set(want) - dropped, f"{rel}: definitions differ"
    imports = {n for n, s in got.items() if s.startswith(("import ",
                                                          "from "))}
    drifted = sorted(n for n in got if got[n] != want[n]
                     and n not in imports | {"__doc__", "__all__"})
    assert not drifted, f"{rel} drifted from src/repro/{rel}: {drifted}"
    exported = [set(ast.literal_eval(d["__all__"].split("=", 1)[1]))
                for d in (want, got)]
    assert exported[1] == exported[0] - dropped
