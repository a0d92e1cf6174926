"""What the benchmark may import: nothing of JAX or the JAX package under
mdbench/, and nothing of the program under mdbench/reference/ (top-level
module names compared whole: ``mdhelper_tpu_torch`` is not
``mdhelper_tpu``)."""

import ast

import pytest

from mdbench.harness import spec as specs

FORBIDDEN = {"jax", "jaxlib", "flax", "mdhelper_tpu"}
SOURCES = sorted(p for p in specs.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            if isinstance(head, ast.Constant):
                out.add(head.value.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(specs.BENCH)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=[p.name for p in SOURCES if "reference" in p.parts])
def test_reference_imports_nothing_of_the_program(path):
    assert "mdhelper_tpu_torch" not in top_level_imports(path)


def test_the_check_compares_whole_names():
    assert "mdhelper_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "mdhelper_tpu.ops".split(".")[0] in FORBIDDEN


def test_nothing_reads_the_jax_benchmark():
    """No string of the harness names the JAX package's benchmark script
    (this file spells the name in parts)."""

    script = "bench" + ".py"
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                words = node.value.replace("/", " ").split()
                assert script not in words, path
