"""The port's own copies of the host runtime match their originals.

``byteps_tpu_torch`` imports nothing of ``byteps_tpu``, so it carries
copies of the modules it needs. Their code stays the originals' code:
only comments, docstrings and the package name (in imports, and as a
whole word in string constants such as ``-m byteps_tpu.server``) may
differ, and the C core's copy may hold blocks of its own, each marked
(``_c_code``) and pinned (``PORT_BLOCKS``).
``core/build.py`` (output path, build stamp) and ``core/ffi.py`` (bf16
staging) are the port's own and are not listed here.
"""

import ast
import hashlib
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
# The port's own blocks in its copy of the C core, each pinned by file
# and the sha256 of its text (``_c_code``), with the original's code
# lines it stands in for: the step trace's runtime switch of the trace
# ring and of the worker's trace sites (atomic, as it flips while the
# worker runs), its clock probe, and the server's sum of each key,
# recorded at its push ack. A block not listed, or changed, fails.
PORT_BLOCKS = {
    ("c_api.cc", "280bd1b719b4e79969d8a1bcd0f67455"
                 "c6aef21e244b3827f8a21beea917096c"): (),
    ("trace.cc", "8395fc270ec1c230d4b79ccbac6f373d"
                 "9d7df182ba863f0a1c5a2513cc011d1d"): (),
    ("trace.cc", "ac8b8f1c9b578bdd48ba0a1f9a4d1d08"
                 "2c64b09ee77dd0cec596c88b5ae37a30"): (),
    ("trace.h", "1efc9019c39a7a9c0828918caa51b2f5"
                "443f95e3033c52cb8c877a330d5b0a25"): (),
    ("trace.h", "76522aa7c49337c935a1ffd636b45644"
                "a09ecd6b8affce19aad3a82a1a3c4baa"): (),
    ("worker.cc", "53c6744cc4ad2bb41b03c8c08b0c9967"
                  "1c44a28c58e94b343fc4a711b86c7443"): (),
    ("worker.cc", "2162198eef75f22da7f14e01c14b5dc2"
                  "9f37095000ab8f9d307ca56782931e8c"): (),
    ("worker.h", "1be4f3fba0d76bce440005ef6654959a"
                 "2c3302ce82ded1e1d5c5366fd23678ae"): (),
    ("worker.h", "ad778ce8431d374986182cef59ea2244"
                 "0bf81425a4e8f4b828b95a39e8c85df0"): (
        "  bool trace_on_ = false;",),
}


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
    dropped, the port's own blocks (from a ``// --- port only:`` line to
    ``// --- end port only``) left out, and the sha256 of each such
    block's text (its lines, markers included, trailing blanks
    dropped)."""
    out, blocks, own = [], [], None
    with open(path) as f:
        for line in f:
            mark = line.strip()
            if mark.startswith("// --- port only:"):
                own = []
            if own is None:
                out.append(line.split("//", 1)[0].rstrip())
                continue
            own.append(line.rstrip())
            if mark == "// --- end port only":
                blocks.append(hashlib.sha256(
                    "\n".join(own).encode()).hexdigest())
                own = None
    assert own is None, f"{path}: a port-only block is not closed"
    return out, blocks


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
    code, blocks = _c_code(copy)
    want, _ = _c_code(orig)
    pinned = {h: lines for (f, h), lines in PORT_BLOCKS.items()
              if f == name}
    assert sorted(blocks) == sorted(pinned)
    for line in (line for lines in pinned.values() for line in lines):
        assert want.count(line) == 1, line
        want.remove(line)
    assert code == want
