"""The whole slice: the port's Predictor against ips_tpu.infer.Predictor.

A tiny image config in fp32; the JAX trainer's weights (with non-trivial
BatchNorm statistics) go to the port through the weight bridge. Selected
indices must be equal; probabilities agree to rtol 1e-4 / atol 1e-5
(flax's LayerNorm fast variance and the order of convolution sums).
"""

import json

import jax
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.infer import Predictor as JPredictor
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.infer import Predictor, main

TINY = dict(
    B=2, B_seq=2, n_class=10, is_image=True, enc_type="resnet18",
    n_chan_in=1, n_res_blocks=2, n_token=2, N=23, M=4, I=5,
    patch_size=[16, 16], patch_stride=[16, 16], use_pos=True, H=4, D=128,
    D_k=16, D_v=16, D_inner=256, compute_dtype="float32",
    tasks={"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                     "metric": "accuracy"},
           "task1": {"id": 1, "name": "multi", "act_fn": "sigmoid",
                     "metric": "multilabel_accuracy"}})
TOL = dict(rtol=1e-4, atol=1e-5)


def _perturb_stats(tree, rng):
    return {k: (_perturb_stats(v, rng) if hasattr(v, "items") else
                (rng.normal(0, 0.2, np.shape(v)) if k == "mean" else
                 rng.uniform(0.5, 2.0, np.shape(v))).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_trainer():
    tr = JTrainer(j_config(dict(TINY)), rng=jax.random.PRNGKey(0),
                  init_opt=False)
    stats = _perturb_stats(tr.state.batch_stats, np.random.default_rng(1))
    tr.state = tr.state.replace(
        batch_stats=jax.tree_util.tree_map(jax.numpy.asarray, stats))
    return tr


def _pair(jax_trainer, **over):
    jp = JPredictor(j_config(dict(TINY, **over)), trainer=jax_trainer)
    tp = Predictor(t_config(dict(TINY, **over)), device="cpu")
    weights.load_jax(tp.trainer.model, jax_trainer.state.params,
                     jax_trainer.state.batch_stats)
    return jp, tp


def _inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.random((B, 23, 16, 16, 1), np.float32)
    x[:, rng.random(23) < 0.4] = 0.0           # blank patches, as in MNIST
    return x


@pytest.mark.parametrize("over", [
    {}, {"eval_reuse_emb": False}, {"mask_padding": True},
    {"score_impl": "attn"}, {"use_pos": False}],
    ids=["reuse_emb", "re_encode", "mask_padding", "attn", "no_pos"])
def test_predictor_matches_jax(jax_trainer, over):
    jp, tp = _pair(jax_trainer, **over)
    x = _inputs(2)
    mask = np.ones((2, 23), bool)
    mask[1, -6:] = False
    for m in (None, mask):
        a, b = jp.predict(x, m), tp.predict(x, m)
        np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
        for name in ("majority", "multi"):
            np.testing.assert_allclose(b[name], a[name], **TOL)
        np.testing.assert_allclose(b["majority"].sum(-1), 1.0, rtol=1e-5)


def test_predictor_bf16_input_storage(jax_trainer):
    """input_dtype='bfloat16' casts the patch tensor once up front."""
    jp, tp = _pair(jax_trainer, input_dtype="bfloat16")
    x = _inputs(3)
    a, b = jp.predict(x), tp.predict(x)
    np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
    np.testing.assert_allclose(b["majority"], a["majority"], **TOL)


def test_predictor_shortcut_when_m_covers_n(jax_trainer):
    jp = JPredictor(j_config(dict(TINY, M=23)), trainer=jax_trainer)
    tp = Predictor(t_config(dict(TINY, M=23)), device="cpu")
    weights.load_jax(tp.trainer.model, jax_trainer.state.params,
                     jax_trainer.state.batch_stats)
    x = _inputs(4)
    a, b = jp.predict(x), tp.predict(x)
    np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
    np.testing.assert_allclose(b["multi"], a["multi"], **TOL)


def test_predictor_needs_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(t_config(dict(TINY)))
    assert Predictor(t_config(dict(TINY)), device="cpu").device.type == "cpu"


def test_predictor_from_trainer_and_deterministic():
    conf = t_config(dict(TINY))
    p1 = Predictor(conf, device="cpu")
    p2 = Predictor(conf, trainer=p1.trainer)
    p3 = Predictor(conf.replace(seed=5), device="cpu")
    x = _inputs(5)
    a, b, c = p1.predict(x), p2.predict(x), p3.predict(x)
    np.testing.assert_array_equal(a["selected_idx"], b["selected_idx"])
    np.testing.assert_array_equal(a["majority"], b["majority"])
    assert not np.allclose(a["majority"], c["majority"])


@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_cli_main(tmp_path, capsys, fmt):
    conf = dict(TINY)
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(conf))
    pred = Predictor(t_config(dict(conf)), device="cpu")
    ckpt = str(tmp_path / f"w.{fmt}")
    if fmt == "pt":
        torch.save(pred.trainer.model.state_dict(), ckpt)
    else:
        weights.save_npz(pred.trainer.model, ckpt)
    x = _inputs(6, B=3)
    np.save(tmp_path / "a.npy", x[0])
    np.save(tmp_path / "b.npy", x[1:])
    out = tmp_path / "preds.json"
    main(["--config", str(cfg), "--checkpoint", ckpt, "--device", "cpu",
          "--input", str(tmp_path / "*.npy"), "--output", str(out)])
    rows = json.loads(out.read_text())
    assert [r["input"] for r in rows] == ["a.npy", "b.npy[0]", "b.npy[1]"]
    direct = pred.predict(x)
    for i, r in enumerate(rows):
        assert r["selected_patches"] == direct["selected_idx"][i].tolist()
        np.testing.assert_allclose(r["majority"]["probs"],
                                   direct["majority"][i], atol=1e-5)
        assert len(r["multi"]["pred"]) == 10


def test_cli_image_input(tmp_path, capsys):
    from PIL import Image
    img = (np.random.default_rng(7).random((48, 32)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "img.png")
    conf = dict(TINY, N=6, M=2, I=2)
    cfg = tmp_path / "conf.json"
    cfg.write_text(json.dumps(conf))
    pred = Predictor(t_config(dict(conf)), device="cpu")
    ckpt = str(tmp_path / "w.pt")
    torch.save(pred.trainer.model.state_dict(), ckpt)
    main(["--config", str(cfg), "--checkpoint", ckpt, "--device", "cpu",
          "--input", str(tmp_path / "img.png")])
    rows = json.loads(capsys.readouterr().out)
    assert rows[0]["input"] == "img.png"
    assert len(rows[0]["selected_patches"]) == 2
