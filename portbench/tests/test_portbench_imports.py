"""Nothing under portbench/ imports JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cpu_tsdf_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def test_no_jax_anywhere():
    files = list(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_port():
    for f in (HERE / "reference").rglob("*.py"):
        assert "cpu_tsdf_tpu_torch" not in imported(f), f
        assert not imported(f) & {"portbench"} or all(
            n.startswith("portbench.reference") for n in _full(f) if n.startswith("portbench")), f


def _full(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
        elif isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
    return out
