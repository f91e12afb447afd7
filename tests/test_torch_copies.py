"""The port's own copies of the host runtime match their originals.

``byteps_tpu_torch`` imports nothing of ``byteps_tpu``, so it carries
copies of the modules it needs. Their code stays the originals' code:
only comments, docstrings and the package name (in imports, and as a
whole word in string constants such as ``-m byteps_tpu.server``) may
differ.
``core/build.py`` (output path, build stamp) and ``core/ffi.py`` (bf16
staging) are the port's own and are not listed here.
"""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("core", "csrc")
PY_COPIES = ["config.py", "partition.py", "core/__init__.py",
             "monitor/__init__.py", "monitor/metrics.py", "monitor/http.py",
             "monitor/timeline.py", "monitor/insight.py",
             "monitor/incident.py", "monitor/top.py", "client.py",
             "server/__init__.py", "server/__main__.py",
             "launcher/__init__.py", "launcher/__main__.py",
             "launcher/launch.py"]
C_COPIES = sorted(os.listdir(os.path.join(ROOT, "byteps_tpu", CSRC)))


def _py_code(path, rename):
    """ast.dump of a module without docstrings, with ``byteps_tpu``
    renamed to the port in imports and, as a whole word, in string
    constants when ``rename``."""
    with open(path) as f:
        tree = ast.parse(f.read())

    def port(name):
        if rename and (name == "byteps_tpu"
                       or name.startswith("byteps_tpu.")):
            return "byteps_tpu_torch" + name[len("byteps_tpu"):]
        return name

    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = port(node.module)
        if isinstance(node, ast.Import):
            for alias in node.names:
                alias.name = port(alias.name)
        if (rename and isinstance(node, ast.Constant)
                and isinstance(node.value, str)):
            node.value = re.sub(r"\bbyteps_tpu\b", "byteps_tpu_torch",
                                node.value)
    return ast.dump(tree)


def _c_code(path):
    """The file's lines with ``//`` comments cut off and trailing blanks
    dropped."""
    with open(path) as f:
        return [line.split("//", 1)[0].rstrip() for line in f]


def test_copy_lists_cover_the_port():
    port_csrc = sorted(os.listdir(os.path.join(ROOT, "byteps_tpu_torch",
                                               CSRC)))
    assert port_csrc == C_COPIES
    for rel in PY_COPIES:
        assert os.path.exists(os.path.join(ROOT, "byteps_tpu_torch", rel))


@pytest.mark.parametrize("rel", PY_COPIES)
def test_python_copy_has_the_original_code(rel):
    orig = os.path.join(ROOT, "byteps_tpu", rel)
    copy = os.path.join(ROOT, "byteps_tpu_torch", rel)
    assert _py_code(copy, rename=False) == _py_code(orig, rename=True)


@pytest.mark.parametrize("name", C_COPIES)
def test_core_source_copy_has_the_original_code(name):
    orig = os.path.join(ROOT, "byteps_tpu", CSRC, name)
    copy = os.path.join(ROOT, "byteps_tpu_torch", CSRC, name)
    assert _c_code(copy) == _c_code(orig)
