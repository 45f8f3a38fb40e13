"""Every command-line entry point of the port turns TF32 off for cuBLAS
and cuDNN before it does anything else (``utils.device.fp32_matmuls``),
whatever the process had set: PyTorch's default leaves
``cudnn.allow_tf32`` on, which would round an fp32 conv's inputs."""

import ast
import glob
import importlib
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# module -> argv that stops it right after its first statement (an
# unknown flag is an argparse error); None: the module's main takes none
CLIS = {
    "ips_tpu_torch.main": ["--no-such-flag"],
    "ips_tpu_torch.infer": ["--no-such-flag"],
    "ips_tpu_torch.export": ["--no-such-flag"],
    "ips_tpu_torch.data.mnist": ["--no-such-flag"],
    "ips_tpu_torch.data.traffic_synth": ["--no-such-flag"],
    "ips_tpu_torch.data.camelyon.synth": ["--no-such-flag"],
    "ips_tpu_torch.data.camelyon.otsu": ["--no-such-flag"],
    "ips_tpu_torch.data.camelyon.foreground": ["--no-such-flag"],
    "ips_tpu_torch.data.camelyon.extract_feat": ["--no-such-flag"],
    "ips_tpu_torch.models.pretrained": ["--no-such-flag"],
    "ips_tpu_torch.scripts.probe_conv": ["--no-such-flag"],
    "ips_tpu_torch.scripts.step_memory": ["--no-such-flag"],
    "ips_tpu_torch.scripts.e2e_learning": ["--no-such-flag"],
    "ips_tpu_torch.scripts.traffic_learning": ["--no-such-flag"],
    "ips_tpu_torch.scripts.mnist_learning": ["--no-such-flag"],
    "ips_tpu_torch.scripts.init_study": ["--no-such-flag"],
    "ips_tpu_torch.scripts.trained_eval": ["--no-such-flag"],
    "ips_tpu_torch.examples.minimal_ips": ["--no-such-flag"],
    "ips_tpu_torch.scripts.kernel_times": None,
    "ips_tpu_torch.scripts.train_parity": None,
}


def test_every_main_is_listed():
    found = set()
    for path in glob.glob(os.path.join(REPO, "ips_tpu_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        if any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in tree.body):
            rel = os.path.relpath(path, REPO)[:-3]
            found.add(rel.replace(os.sep, "."))
    assert found == set(CLIS)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("module", sorted(CLIS))
def test_main_turns_tf32_off(module, monkeypatch):
    mod = importlib.import_module(module)
    if module.endswith("train_parity"):       # it runs on the card only
        def stop(*a, **kw):
            raise _Stop
        monkeypatch.setattr(mod, "parity", stop)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        argv = CLIS[module]
        if argv is None:
            try:
                mod.main()        # kernel_times returns 1 without a card
            except _Stop:
                pass
        else:
            with pytest.raises(SystemExit):
                mod.main(argv)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
