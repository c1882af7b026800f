"""What the benchmark may import: the reference and the yardstick nothing
of the program, of JAX or of the JAX package; nothing of the benchmark
JAX or the JAX package (top-level names compared whole)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
NEVER = {"jax", "jaxlib", "flax", "inverse_flow_tpu"}
# the yardstick: the reference, the inputs, the arithmetic, the comparison
YARDSTICK = ["reference/glow.py", "inputs.py", "work.py", "compare.py",
             "trace.py", "readers.py"]


def imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), BENCH)


@pytest.mark.parametrize("rel", sorted(sources()))
def test_no_jax_anywhere(rel):
    assert not imports(os.path.join(BENCH, rel)) & NEVER


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    found = imports(os.path.join(BENCH, rel))
    assert "inverse_flow_tpu_torch" not in found
    assert found <= {"__future__", "math", "numpy", "torch", "hashlib",
                     "bisect", "statistics", "benchmark"}
