"""No file of the benchmark imports JAX or the JAX package; the references import nothing of the port."""

import ast
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "image_enhance_keras_tpu"}
PORT = "image_enhance_keras_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _files(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere():
    bad = [(p, m) for p in _files() for m in _imports(p) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_reference_imports_nothing_of_the_port():
    bad = [(p, m) for p in _files("reference") for m in _imports(p) if m.split(".")[0] in FORBIDDEN | {PORT}]
    assert not bad, bad


def test_the_rule_compares_whole_names():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "image_enhance_keras_tpu.engine".split(".")[0] in FORBIDDEN
