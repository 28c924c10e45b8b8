"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: every import's top-level
name, compared whole (``riggs_tpu_torch`` begins with ``riggs_tpu``)."""
from __future__ import annotations

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "riggs_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(HERE)): sorted(top_level_imports(f) & FORBIDDEN) for f in files}
    assert {f: n for f, n in bad.items() if n} == {}


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HERE / "reference").rglob("*.py"))
    assert files
    for f in files:
        names = top_level_imports(f)
        assert "riggs_tpu_torch" not in names, f
        assert names <= {"__future__", "numpy", "torch", "portbench"}, (f, names)
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), (f, node.module)


def test_the_guard_compares_whole_names():
    import sys

    from portbench import harness

    assert "riggs_tpu_torch" not in harness.forbidden_modules()
    sys.modules["riggs_tpu.fake"] = sys.modules["json"]
    try:
        assert "riggs_tpu" in harness.forbidden_modules()
    finally:
        del sys.modules["riggs_tpu.fake"]
