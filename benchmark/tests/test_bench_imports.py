"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level module names compared
whole: the port's name starts with the JAX package's)."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "ecrad_tpu"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(HERE, "reference")):
        names = set(_imports(path))
        assert "ecrad_torch" not in names, path
        assert not names & JAX, path


def test_whole_names_compared():
    """The port's name starts with the JAX package's; it is not it."""
    assert "ecrad_torch".split(".")[0] not in JAX
    assert "ecrad_tpu" in JAX


def test_a_run_loads_no_jax():
    """Importing the harness, the program and the reference, and running
    the port's step, loads none of the forbidden modules."""
    probe = (
        "import sys; before = set(sys.modules); sys.path.insert(0, %r)\n"
        "from benchmark import run, calibrate, program, inputs, check\n"
        "from benchmark.reference import step\n"
        "import ecrad_torch.pipeline, ecrad_torch.interface\n"
        "new = set(sys.modules) - before\n"
        "print(sorted({m.split('.')[0] for m in new} & set(run.FORBIDDEN)))"
        "\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
