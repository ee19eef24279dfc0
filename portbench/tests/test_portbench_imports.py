"""Nothing the benchmark runs loads JAX or the JAX package; the plain
references load nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.yardstick import guard

BASE = Path(__file__).resolve().parents[1]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("path", sorted((BASE / "reference").glob("*.py")) + sorted((BASE / "yardstick").glob("*.py")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_reference_and_yardstick_import_nothing_of_the_port(path):
    assert not _imports(path) & {"lanczos_adjoints_tpu_torch", *guard.FORBIDDEN}


@pytest.mark.parametrize("path", sorted(BASE.rglob("*.py")), ids=lambda p: str(p.relative_to(BASE)))
def test_no_file_imports_jax(path):
    assert not _imports(path) & set(guard.FORBIDDEN)


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["lanczos_adjoints_tpu_torch", "lanczos_adjoints_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen", "lanczos_adjoints_tpu.ops"]) == [
        "flax", "jax", "jaxlib", "lanczos_adjoints_tpu"]


def test_references_load_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.gp_train_step, "
            "portbench.reference.lanczos_vjp; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'lanczos_adjoints_tpu_torch', 'jax', "
            "'jaxlib', 'flax', 'lanczos_adjoints_tpu'}))") % str(BASE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_a_cell_loads_no_jax():
    """The port and both runners, once loaded, leave no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r); import portbench.core as c; "
            "import lanczos_adjoints_tpu_torch.train.gp, lanczos_adjoints_tpu_torch.krylov.lanczos, "
            "lanczos_adjoints_tpu_torch.ops.sparse; from portbench.yardstick import guard; "
            "print(guard.forbidden_loaded())") % str(BASE.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"
