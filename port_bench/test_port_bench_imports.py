"""No module the benchmark runs imports JAX, its relatives or the JAX
package ``repro`` (top-level names compared whole: ``repro_torch`` is
the program), nothing of it reads the old benchmark folder of the JAX
package, and the reference and
the yardstick import nothing of the program."""
from __future__ import annotations

import ast

import pytest

from port_bench import bench

FILES = sorted(p for p in bench.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)
YARDSTICK = ("reference", "roofline.py", "traffic.py", "weights.py",
             "timing.py", "kernels.py", "bench.py")


def imported(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_and_no_old_benchmarks(path):
    assert not imported(path) & set(bench.FORBIDDEN)
    assert "benchmarks" + "/" not in path.read_text()


@pytest.mark.parametrize(
    "path", [p for p in FILES if any(y in p.relative_to(bench.HERE).parts
                                     for y in YARDSTICK)],
    ids=lambda p: str(p.relative_to(bench.HERE)))
def test_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in imported(path)


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.models.lm", "port_bench.bench"], []),
    (["repro", "repro.models"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax.linen", "numpy"], ["flax", "jax",
                                                      "jaxlib"]),
    (["jax_extras", "reprocess"], []),
])
def test_forbidden_names_are_compared_whole(names, found):
    assert bench.forbidden_modules(names) == found
