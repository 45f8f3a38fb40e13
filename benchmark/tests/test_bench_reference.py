"""The plain reference against the port at a tiny size on the CPU, both
in float32: one fused select-and-train step of the MNIST configuration,
one chunked step of camelyon_e2e over masked slides, and served
predictions. The test imports both; the reference imports nothing of the
port."""

import numpy as np
import pytest
import torch

from benchmark import core, weights
from benchmark.reference import ips as R


def _port(conf_d):
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.train.steps import IPSTrainer
    from ips_tpu_torch.weights import load_flat
    w = weights.draw(conf_d, 2 ** 31 + 5, "cpu")
    tr = IPSTrainer(config_from_dict(conf_d), device="cpu")
    load_flat(tr.model, {k: v.numpy() for k, v in w.items()})
    return tr, w


def _labels(conf_d, B, g):
    out = {}
    for t in R.task_list(conf_d):
        out[t["name"]] = (torch.randint(0, conf_d["n_class"], (B,),
                                        generator=g)
                          if t["act_fn"] == "softmax" else
                          torch.randint(0, 2, (B,), generator=g))
    return out


@pytest.mark.parametrize("name,chunk", [("mnist", 0), ("camelyon_e2e", 2)])
def test_one_training_step(name, chunk):
    from ips_tpu_torch.weights import to_flat
    R.fp32_only()
    cell = {"mnist": "mnist.train", "camelyon_e2e": "camelyon_e2e.train"}
    conf_d = dict(core.find_cell(cell[name]).config,
                  compute_dtype="float32", input_dtype="float32", M=4, I=4,
                  grad_encode_chunk=chunk)
    g = torch.Generator().manual_seed(3)
    if name == "mnist":
        B, N = 4, 16
        conf_d.update(N=N, B=B, B_seq=B)
        x = torch.rand((B, N, 50, 50, 1), generator=g) * (
            torch.rand((B, N, 1, 1, 1), generator=g) > 0.5)
        valid = torch.ones((B, N), dtype=torch.bool)
    else:
        B, N = 2, 12
        conf_d.update(B=B, patch_size=[32, 32], patch_stride=[32, 32])
        x = torch.randint(0, 256, (B, N, 32, 32, 3), generator=g,
                          dtype=torch.uint8)
        valid = torch.arange(N)[None].expand(B, N) < 10
    tr, w = _port(conf_d)
    lab = _labels(conf_d, B, g)
    loss, _, preds = tr.fused_step(x, valid, lab, torch.ones(B),
                                   tr.new_generator(11), 1e-3)
    ref = R.RefIPS(conf_d, {k: v.clone() for k, v in w.items()})
    gen = torch.Generator().manual_seed(11)
    idx, _ = ref.select(x, R.permutation(gen, B, N, valid, True), valid)
    rows = torch.arange(B)[:, None]
    r_loss, _, r_preds, _ = ref.train_step(x[rows, idx], idx, lab,
                                           torch.ones(B), gen, 1e-3, chunk)
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    for k in preds:
        assert torch.allclose(preds[k], r_preds[k], atol=1e-5)
    flat = to_flat(tr.model)
    for k, v in ref.P.items():
        # AdamW's first update is lr * sign(g): a gradient within rounding
        # of zero may take either sign, so compare the leaf's norm
        assert np.linalg.norm(flat[k] - w[k].numpy()) == pytest.approx(
            float((v - w[k]).norm()), rel=1e-2, abs=1e-6), k


def test_served_predictions():
    from ips_tpu_torch.config import config_from_dict
    from ips_tpu_torch.infer import Predictor
    from ips_tpu_torch.weights import load_flat
    R.fp32_only()
    conf_d = dict(core.find_cell("mnist.serve").config,
                  compute_dtype="float32", input_dtype="float32", M=4, I=4,
                  N=16)
    w = weights.draw(conf_d, 9, "cpu")
    pred = Predictor(config_from_dict(conf_d), device="cpu")
    load_flat(pred.trainer.model, {k: v.numpy() for k, v in w.items()})
    x = torch.rand((3, 16, 50, 50, 1), generator=torch.Generator()
                   .manual_seed(1)).numpy()
    out = pred.predict(x)
    ref = R.RefIPS(conf_d, w)
    from benchmark import check
    got = check.reference_serve(conf_d, ref, torch.from_numpy(x))
    assert np.array_equal(got["kept"], out["selected_idx"])
    for t in got["probs"]:
        assert np.allclose(got["probs"][t], out[t], atol=1e-5)
    nums = check.serve_numbers(conf_d, ref, torch.from_numpy(x),
                               out["selected_idx"], out)
    assert nums["sel_gap"] == 0.0 and nums["prob_gap"] < 1e-5
