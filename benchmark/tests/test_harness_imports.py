"""What the benchmark may import: nothing of JAX or the JAX package
anywhere under ``benchmark/``, and nothing of the program under test in
the reference. Top-level module names are compared whole: the port's
name, ``idmvton_tpu_torch``, begins with the JAX package's."""

import ast

import pytest

from benchmark.harness import common

FORBIDDEN = {"jax", "jaxlib", "flax", "idmvton_tpu"}
PORT = "idmvton_tpu_torch"


def imported(path):
    """Top-level names of every module that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(common.BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(common.BENCH))
                              for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((common.BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in imported(path)
    assert PORT not in path.read_text()


def test_the_check_compares_whole_names():
    assert {"idmvton_tpu_torch"} & FORBIDDEN == set()
    assert imported(common.BENCH / "harness" / "serve.py") & {PORT}
