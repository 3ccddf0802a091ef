"""No module of the benchmark imports JAX or the JAX package, and the
references import nothing of the port: each imported top-level name
compared whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "imagecaptioner_tpu"}
MODULES = sorted(p for p in spec.HERE.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: str(p.relative_to(spec.HERE)))
def test_no_jax_and_a_port_free_reference(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    if "reference" in path.relative_to(spec.HERE).parts:
        assert "imagecaptioner_tpu_torch" not in names


def test_whole_names_compared():
    """The port's name begins with the JAX package's and is not it."""
    assert "imagecaptioner_tpu_torch".split(".")[0] not in FORBIDDEN


def test_references_load_nothing_of_the_port():
    code = ("import sys; import portbench.reference.kd, "
            "portbench.reference.teacher; "
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'imagecaptioner_tpu', "
            "'imagecaptioner_tpu_torch')); print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
