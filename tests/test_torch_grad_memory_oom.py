"""The train step's out-of-memory error (``GradEncodeMemoryError``) on the
CPU, with ``IPSModel.encode`` patched to raise PyTorch's
``torch.cuda.OutOfMemoryError`` as the card's allocator does.

The JAX package's compiler refuses a step whose temporaries do not fit
before it runs; the port's trainer names the setting that bounds the
re-encode's memory instead, chained to PyTorch's error, before any
update, and never retries at another ``grad_encode_chunk`` (each chunk
takes its own BatchNorm statistics, so that would train another
function). An out-of-memory error anywhere else, and any other error,
passes through unchanged. The card's counterpart, a real allocation too
large for the card, is in tests/test_torch_gpu.py.
"""

import os

import numpy as np
import pytest
import torch

from ips_tpu_torch.config import config_from_dict
from ips_tpu_torch.models.ips_net import IPSModel
from ips_tpu_torch.scripts.train_parity import SMALL_TRAIN
from ips_tpu_torch.train.steps import GradEncodeMemoryError, IPSTrainer

# PyTorch's own wording, with the figures of the card's unchunked
# camelyon_e2e step (PERF.md §5)
OOM_TEXT = ("CUDA out of memory. Tried to allocate 6.12 GiB. GPU 0 has a "
            "total capacity of 79.18 GiB of which 5.52 GiB is free. Process "
            "1 has 73.65 GiB memory in use. Of the allocated memory 70.96 "
            "GiB is allocated by PyTorch, and 1.95 GiB is reserved by "
            "PyTorch but unallocated.")
B, N, M = 2, 80, 64


def _conf(chunk, **over):
    return config_from_dict(dict(SMALL_TRAIN, B=B, B_seq=B, N=N, M=M, I=8,
                                 grad_encode_chunk=chunk, **over))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((B, N, 16, 16, 1), np.float32))
    labels = {"majority": torch.from_numpy(rng.integers(0, 10, B)),
              "multi": torch.from_numpy(
                  (rng.random((B, 10)) < 0.5).astype(np.float32))}
    return x, labels, torch.ones(B)


def _raising(error, when_train):
    """``IPSModel.encode`` that raises ``error`` on its train-mode
    (``when_train``) or eval-mode calls and encodes the others."""
    encode = IPSModel.encode

    def patched(self, x, train=False, weights=None):
        if bool(train) == when_train:
            raise error
        return encode(self, x, train, weights)
    return patched


def _state(tr):
    out = {f"model/{k}": v.clone() for k, v in tr.model.state_dict().items()}
    for i, st in enumerate(tr.opt.state.values()):
        out.update({f"opt/{i}/{k}": v.clone() for k, v in st.items()
                    if isinstance(v, torch.Tensor)})
    return out


def _step(tr, path, x, labels, w, seed):
    if path == "train_step":
        mem = tr.select(x, None, tr.new_generator(seed))
        return tr.train_step(mem[0], mem[1], mem[3], labels, w,
                             tr.new_generator(seed), 1e-3)
    return tr.fused_step(x, None, labels, w, tr.new_generator(seed), 1e-3)


@pytest.mark.parametrize("path", ["train_step", "fused_step"])
@pytest.mark.parametrize("chunk", [0, 32])
def test_out_of_memory_in_the_re_encode_names_the_chunk(monkeypatch, chunk,
                                                        path):
    """One good step (AdamW state exists), then a step whose train-mode
    encode runs out of memory: GradEncodeMemoryError names
    grad_encode_chunk, its value, B·M and the request PyTorch's error
    states, chains to that very error, and leaves every parameter, running
    statistic and AdamW moment bitwise as it was, the step counter too."""
    tr = IPSTrainer(_conf(chunk), device="cpu")
    x, labels, w = _batch()
    _step(tr, path, x, labels, w, 0)
    before, step = _state(tr), tr.step
    oom = torch.cuda.OutOfMemoryError(OOM_TEXT)
    monkeypatch.setattr(IPSModel, "encode", _raising(oom, when_train=True))
    with pytest.raises(GradEncodeMemoryError) as err:
        _step(tr, path, x, labels, w, 1)
    text = str(err.value)
    assert f"grad_encode_chunk={chunk}" in text
    assert f"B·M = {B}·{M} = {B * M}" in text
    assert "asked for 6.12 GiB more" in text
    assert ("held 70.96 GiB allocated (1.95 GiB more reserved) of the "
            "device's 79.18 GiB") in text
    assert (f"slices of B·c = {B}·{chunk}" in text) == (0 < chunk < M)
    assert err.value.__cause__ is oom
    assert isinstance(err.value, torch.cuda.OutOfMemoryError)
    after = _state(tr)
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert tr.step == step
    assert all(p.grad is None for p in tr.model.parameters())


@pytest.mark.parametrize("where", ["selection", "eval", "re_encode"])
def test_other_errors_pass_through(monkeypatch, where):
    """An out-of-memory error in selection or in an eval step, and a plain
    RuntimeError in the gradient re-encode, reach the caller as the very
    error raised, not as GradEncodeMemoryError."""
    tr = IPSTrainer(_conf(0), device="cpu")
    x, labels, w = _batch()
    if where == "re_encode":
        error = RuntimeError("a fault that is not memory")
    else:
        error = torch.cuda.OutOfMemoryError(OOM_TEXT)
    monkeypatch.setattr(IPSModel, "encode", _raising(
        error, when_train=where == "re_encode"))
    with pytest.raises(type(error)) as err:
        if where == "eval":
            tr.fused_eval_step(x, None, labels, w, tr.new_generator(0))
        else:
            tr.fused_step(x, None, labels, w, tr.new_generator(0), 1e-3)
    assert err.value is error
    assert not isinstance(err.value, GradEncodeMemoryError)
    assert tr.step == 0


def test_driver_run_ends_with_the_error_and_writes_nothing(monkeypatch,
                                                           tmp_path):
    """``main.run`` of camelyon_e2e with the shipped grad_encode_chunk (0)
    on a tiny in-memory corpus (streaming selection of 32x32 tiles),
    checkpoints and metrics asked for: the first step's re-encode runs
    out of memory, the run ends with GradEncodeMemoryError after every
    train slide was selected, and no checkpoint or metrics line exists."""
    from ips_tpu_torch import main
    from ips_tpu_torch.data.camelyon.patches import (CamelyonPatches,
                                                     synth_tile_slides)
    conf = config_from_dict(dict(
        n_epoch=2, B=2, B_seq=1, n_epoch_warmup=1, lr=1e-3, n_class=1,
        n_worker=2, eager=False, stream_chunk_group=2, is_image=True,
        enc_type="resnet50", n_chan_in=3, n_res_blocks=2, n_token=1, N=0,
        M=4, I=4, patch_size=[32, 32], patch_stride=[32, 32],
        use_pos=False, H=2, D=512, D_k=8, D_v=8, D_inner=32,
        compute_dtype="float32",
        tasks={"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                         "metric": "auc"}},
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1,
        metrics_path=str(tmp_path / "metrics.jsonl")))
    assert conf.grad_encode_chunk == 0
    train = CamelyonPatches(conf, True, slides=synth_tile_slides(
        [9, 7], (32, 32), seed=0))
    test = CamelyonPatches(conf, False, slides=synth_tile_slides(
        [6], (32, 32), seed=1))
    selected = []
    select = IPSTrainer.select_streaming

    def counted(self, *a, **kw):
        selected.append(1)
        return select(self, *a, **kw)
    monkeypatch.setattr(IPSTrainer, "select_streaming", counted)
    oom = torch.cuda.OutOfMemoryError(OOM_TEXT)
    monkeypatch.setattr(IPSModel, "encode", _raising(oom, when_train=True))
    with pytest.raises(GradEncodeMemoryError) as err:
        main.run(conf, "camelyon_e2e", device="cpu", datasets=(train, test))
    assert err.value.__cause__ is oom
    assert "grad_encode_chunk=0" in str(err.value)
    assert f"B·M = 2·{conf.M}" in str(err.value)
    assert len(selected) == len(train)
    assert os.listdir(tmp_path / "ckpt") == []
    assert not (tmp_path / "metrics.jsonl").exists()
