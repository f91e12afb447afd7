"""What the benchmark may import: never JAX or the JAX package (compared
by whole top-level names, since ``byteps_tpu_torch`` begins with
``byteps_tpu``), and in the reference nothing of the port either; and it
reads none of the JAX package's old benchmark files."""

import ast
import os
import sys

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "byteps_tpu"}
# the JAX package's benchmark scripts and results at the repo's root
OLD = [f for f in os.listdir(os.path.dirname(HERE))
       if f.startswith(("bench", "BENCH_", "MULTICHIP_"))
       and f.endswith((".py", ".json"))]


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_port_in_the_reference(path):
    tops = {name.partition(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if os.sep + "reference" + os.sep in path:
        assert "byteps_tpu_torch" not in tops
    text = open(path).read()
    assert not any(name in text for name in OLD), path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "byteps_tpu_torch_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    assert run.FORBIDDEN == tuple(sorted(FORBIDDEN, key=run.FORBIDDEN.index))
