"""The port imports nothing of JAX or of the JAX package."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ips_tpu")
SOURCES = sorted(glob.glob(os.path.join(REPO, "ips_tpu_torch", "**", "*.py"),
                           recursive=True)) + [
    os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
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


def test_sources_found():
    assert len(SOURCES) > 10
    rel = {os.path.relpath(p, REPO) for p in SOURCES}
    assert {"ips_tpu_torch/ops/score_kernel.py",
            "ips_tpu_torch/ops/conv_block.py",
            "ips_tpu_torch/scripts/probe_conv.py",
            "ips_tpu_torch/scripts/kernel_times.py",
            "ips_tpu_torch/utils/timing.py",
            "ips_tpu_torch/main.py",
            "ips_tpu_torch/native.py",
            "ips_tpu_torch/data/mnist.py",
            "ips_tpu_torch/data/camelyon/dataset.py",
            "ips_tpu_torch/data/camelyon/slide.py",
            "ips_tpu_torch/data/camelyon/patches.py",
            "ips_tpu_torch/train/streaming.py",
            "ips_tpu_torch/train/loop.py",
            "ips_tpu_torch/models/pretrained.py",
            "ips_tpu_torch/data/camelyon/methods.py",
            "ips_tpu_torch/data/camelyon/synth.py",
            "ips_tpu_torch/data/camelyon/otsu.py",
            "ips_tpu_torch/data/camelyon/foreground.py",
            "ips_tpu_torch/data/camelyon/extract_feat.py",
            "ips_tpu_torch/data/camelyon/viz.py",
            "ips_tpu_torch/scripts/e2e_learning.py",
            "ips_tpu_torch/data/traffic.py",
            "ips_tpu_torch/data/traffic_synth.py",
            "ips_tpu_torch/scripts/traffic_learning.py",
            "ips_tpu_torch/models/quant.py",
            "ips_tpu_torch/export.py",
            "ips_tpu_torch/parallel/mesh.py",
            "ips_tpu_torch/parallel/distributed.py",
            "ips_tpu_torch/parallel/ips_sharded.py",
            "ips_tpu_torch/parallel/launch.py"} <= rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, REPO) for p in SOURCES])
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom ips_tpu.config import Config\n"
                 "def f():\n    import flax.linen\n")
    assert {"ips_tpu", "flax"} <= set(_imported_roots(str(p)))
