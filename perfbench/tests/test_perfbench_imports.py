"""No file of the benchmark imports JAX, its relatives or the JAX package:
an AST walk over every Python file under perfbench/, comparing the
top-level name of each imported module (the part before the first dot)
whole, so that libdmet_preview_tpu_torch passes and libdmet_preview_tpu
does not."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "libdmet_preview_tpu"}


def _imported_top_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    bad = set(_imported_top_names(path)) & FORBIDDEN
    assert not bad, "%s imports %s" % (path, sorted(bad))


def test_the_walk_sees_every_kind_of_import(tmp_path):
    f = tmp_path / "probe.py"
    f.write_text("import jax.numpy\nfrom libdmet_preview_tpu.ops import x\n"
                 "import libdmet_preview_tpu_torch\n"
                 "importlib.import_module('flax.linen')\n")
    assert set(_imported_top_names(f)) & FORBIDDEN == {
        "jax", "libdmet_preview_tpu", "flax"}


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").rglob("*.py")):
        names = set(_imported_top_names(path))
        assert "libdmet_preview_tpu_torch" not in names, path
