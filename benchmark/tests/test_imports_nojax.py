"""No module under benchmark/ imports JAX or the JAX package, compared by
whole top-level name (the port's name starts with the JAX package's), and
the plain reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.core import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "uneven_planner_tpu"}
PROGRAM = "uneven_planner_tpu_torch"


def sources(sub=""):
    top = os.path.join(cells.BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_jax_import(path):
    assert not FORBIDDEN.intersection(imported_tops(path)), path


@pytest.mark.parametrize("path", sorted(sources("reference")))
def test_reference_imports_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert PROGRAM not in tops and not FORBIDDEN.intersection(tops)
    assert tops <= {"__future__", "math", "typing", "numpy", "torch",
                    "benchmark"}
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference."), path


def test_reference_runs_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark.reference import fleet as f; "
            "f.figure_eight(0.5, 16, 1.2); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('uneven_planner_tpu_torch', 'uneven_planner_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)") % cells.ROOT
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules([PROGRAM, PROGRAM + ".sim", "numpy"]) == []
    assert run.forbidden_modules(["uneven_planner_tpu.solver", "numpy"]) \
        == ["uneven_planner_tpu"]
    assert run.forbidden_modules(["jaxlib.xla_client", "jax_extra"]) \
        == ["jaxlib"]
    assert run.forbidden_modules(["flax.linen"]) == ["flax"]
