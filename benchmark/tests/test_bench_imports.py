"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names, and the plain reference imports nothing of
the port."""

import ast
import glob
import os

from benchmark import core

FILES = sorted(glob.glob(os.path.join(core.ROOT, "benchmark", "**", "*.py"),
                         recursive=True))


def _roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_files_found():
    rel = {os.path.relpath(p, core.ROOT) for p in FILES}
    assert {"benchmark/run.py", "benchmark/reference/ips.py",
            "benchmark/drivers/train.py"} <= rel


def test_no_jax_anywhere():
    bad = {os.path.relpath(p, core.ROOT): sorted(set(_roots(p))
                                                  & set(core.FORBIDDEN))
           for p in FILES}
    assert not {k: v for k, v in bad.items() if v}
    # the names are compared whole: the port's name begins with the JAX
    # package's and is allowed
    assert "ips_tpu_torch" not in core.FORBIDDEN


def test_reference_names_nothing_of_the_port():
    for p in FILES:
        if os.sep + "reference" + os.sep in p:
            with open(p) as f:
                assert "ips_tpu_torch" not in f.read(), p
            assert "ips_tpu_torch" not in set(_roots(p)), p
