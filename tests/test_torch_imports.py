"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, the reference package ``repro`` or the
reference's ``benchmarks`` and ``tools`` (it keeps its own copies of what
it needs), so it runs on a host without JAX."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "benchmarks", "tools")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/kernels/ops.py", "src/repro_torch/kernels/ref.py",
            "src/repro_torch/models/mamba2.py", "src/repro_torch/models/moe.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/launch/serve.py", "chip_smoke.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/train/train_step.py",
            "src/repro_torch/data/threefry.py",
            "src/repro_torch/checkpoint/store.py",
            "src/repro_torch/configs/specs.py",
            "src/repro_torch/sharding/rules.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/quickstart.py",
            "src/repro_torch/launch/fault_tolerant_training.py",
            "src/repro_torch/launch/carbon_aware_training.py",
            "src/repro_torch/launch/lm_design_space.py",
            "src/repro_torch/launch/costs.py",
            "src/repro_torch/launch/roofline.py",
            "src/repro_torch/obs.py"} <= names
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imports(tree) if _forbidden(mod)]
    assert not bad, f"{path.name} imports {bad}"


def test_checker_catches_forbidden_imports():
    src = ("import jax\nfrom jax import numpy\nimport repro.core\n"
           "from repro.serve import router\nimport repro_torch\n"
           "import importlib\nimportlib.import_module('repro.models')\n"
           "from benchmarks import roofline\nimport tools.render_roofline\n")
    found = [m for _, m in _imports(ast.parse(src)) if _forbidden(m)]
    assert found == ["jax", "jax", "repro.core", "repro.serve", "benchmarks",
                     "tools.render_roofline", "repro.models"]
