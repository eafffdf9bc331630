"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program either."""

import ast
import os

from ugbench import registry

FORBIDDEN = {"jax", "jaxlib", "flax", "ultragrid_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def modules(sub=""):
    for root, _, files in os.walk(os.path.join(registry.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_jax_anywhere():
    found = {(p, t) for p in modules() for t in imported_tops(p) if t in FORBIDDEN}
    assert not found


def test_reference_is_independent_of_the_program():
    found = {(p, t) for p in modules("reference") for t in imported_tops(p)
             if t in FORBIDDEN | {"ultragrid_tpu_torch", "torch"}}
    assert not found
    assert "ultragrid_tpu_torch" in {t for p in modules() for t in imported_tops(p)}
