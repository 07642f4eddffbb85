"""The benchmark imports neither JAX nor the JAX package, its references,
families and traffic import nothing of the program, and nothing reads the JAX
package's ``benchmarks/``. Module names are compared whole: the port
``repro_torch`` is not the JAX package ``repro``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}
INDEPENDENT = ("reference", "traffic", "families")


def modules():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(tree) -> set[str]:
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_independent_references(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = imported(tree)
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"
    if path.relative_to(BENCH).parts[0] in INDEPENDENT:
        assert not names & PROGRAM, f"{path} imports the program"
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            parts = node.value.replace("\\", "/").split("/")
            assert "benchmarks" not in parts[:-1] and not (
                parts[0] == "benchmarks" and len(parts) > 1), (
                f"{path} names the JAX package's benchmarks/: {node.value!r}")


def test_whole_name_comparison():
    tree = ast.parse("import repro_torch.serve\nfrom repro_torch import x\n"
                     "import reproduce\n")
    assert imported(tree) == {"repro_torch", "reproduce"}
    assert not imported(tree) & FORBIDDEN
    assert imported(ast.parse("from repro.serve import r")) & FORBIDDEN
    assert imported(ast.parse("import jax.numpy as jnp")) & FORBIDDEN


def test_only_families_reach_a_models_code():
    """Drivers, the harness, readers and references reach a model only
    through the cell's family: none imports the ``lm`` family's blocks or
    counts by module, or names its ``layer_kind``."""
    paths = [BENCH / "run.py", BENCH / "calibrate.py"] + [
        p for d in ("drivers", "harness", "metrics", "reference")
        for p in sorted((BENCH / d).glob("*.py"))]
    for path in paths:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                mods = {node.module} | {f"{node.module}.{a.name}"
                                        for a in node.names}
                assert not mods & {"bench.reference.lm",
                                   "bench.roofline.counts"}, (path, mods)
            if isinstance(node, ast.Import):
                assert not {a.name for a in node.names} & {
                    "bench.reference.lm", "bench.roofline.counts"}, path
            name = getattr(node, "id", None) or getattr(node, "attr", None)
            assert name != "layer_kind", path
