"""What the benchmark imports: no module of speedbench/ names jax,
jaxlib, flax or radtts_tpu at the top level (compared whole: the program,
radtts_tpu_torch, begins with radtts_tpu), and the plain reference imports
nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "radtts_tpu"}


def sources(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(HERE,
                                                             "reference"))))
def test_the_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "radtts_tpu_torch" not in names and not names & FORBIDDEN


def test_whole_names_are_compared():
    # the program's name begins with the JAX package's: a prefix match
    # would refuse it, a whole-name match must not
    assert "radtts_tpu_torch".split(".")[0] not in FORBIDDEN
