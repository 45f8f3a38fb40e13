"""The port's modules against flax, through the weight bridge.

fp32 on both sides, rtol 1e-4 / atol 1e-5: flax's LayerNorm takes the
variance as E[x^2] - E[x]^2 where torch subtracts the mean first, and the
two frameworks sum convolution products in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.models import encoders as je
from ips_tpu.models import transformer as jt
from ips_tpu.models.ips_net import IPSModel as JModel
from ips_tpu.models.ips_net import init_ips_model
from ips_tpu.models.norm import MaskedBatchNorm as JBN
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.models import encoders as te
from ips_tpu_torch.models import transformer as tt
from ips_tpu_torch.models.ips_net import IPSModel as TModel
from ips_tpu_torch.models.ips_net import init_weights
from ips_tpu_torch.models.norm import MaskedBatchNorm as TBN

TOL = dict(rtol=1e-4, atol=1e-5)

TINY = dict(
    B=2, B_seq=2, n_class=10, is_image=True, enc_type="resnet18",
    n_chan_in=1, n_res_blocks=2, n_token=2, N=12, M=4, I=4,
    patch_size=[16, 16], patch_stride=[16, 16], use_pos=True, H=4, D=128,
    D_k=16, D_v=16, D_inner=256, compute_dtype="float32",
    tasks={"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                     "metric": "accuracy"},
           "task1": {"id": 1, "name": "multi", "act_fn": "sigmoid",
                     "metric": "multilabel_accuracy"}})


def _perturb_stats(tree, rng):
    """Non-trivial running statistics, so BatchNorm is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _perturb_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0, 0.2, np.shape(v)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
    return out


def _jax_variables(module, *args, seed=0, **kw):
    variables = module.init(jax.random.PRNGKey(seed), *args, **kw)
    params = variables["params"]
    stats = _perturb_stats(variables.get("batch_stats", {}),
                           np.random.default_rng(seed + 1))
    return params, stats


def test_masked_batchnorm_eval():
    x = np.random.default_rng(0).standard_normal((4, 3, 3, 5), np.float32)
    params, stats = _jax_variables(JBN(), jnp.asarray(x),
                                   use_running_average=True)
    params = {"scale": np.linspace(0.5, 1.5, 5, dtype=np.float32),
              "bias": np.linspace(-1, 1, 5, dtype=np.float32)}
    ref = JBN().apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), use_running_average=True)
    bn = TBN(5)
    weights.load_jax(bn, params, stats)
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)
    # eval reads the running statistics and leaves them as they were
    np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), stats["var"])


@pytest.mark.parametrize("enc_type,n_blocks,hw", [
    ("resnet18", 2, 16), ("resnet18", 2, 50), ("resnet18", 4, 32),
    ("resnet50", 2, 16)])
def test_conv_encoder_matches_flax(enc_type, n_blocks, hw):
    x = np.random.default_rng(1).random((3, hw, hw, 1), np.float32)
    jm = je.ConvPatchEncoder(enc_type=enc_type, n_chan_in=1,
                             n_res_blocks=n_blocks)
    params, stats = _jax_variables(jm, jnp.asarray(x), train=False)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), train=False)
    tm = te.ConvPatchEncoder(enc_type, 1, n_blocks).eval()
    weights.load_jax(tm, params, stats)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, te.encoder_out_dim(enc_type, n_blocks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_s2d_stem_is_accepted_with_same_output():
    x = np.random.default_rng(2).random((2, 16, 16, 1), np.float32)
    jm = je.ConvPatchEncoder(n_chan_in=1, s2d_stem=True)
    params, stats = _jax_variables(jm, jnp.asarray(x), train=False)
    ref = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), train=False)
    tm = te.ConvPatchEncoder("resnet18", 1, 2, s2d_stem=True).eval()
    weights.load_jax(tm, params, stats)
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref), **TOL)


def test_pos_enc_table_equal():
    np.testing.assert_array_equal(tt.pos_enc_1d_np(128, 900),
                                  jt.pos_enc_1d_np(128, 900))
    with pytest.raises(ValueError):
        tt.pos_enc_1d_np(7, 3)


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_matches_flax(masked):
    B, L, D = 2, 9, 32
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, D), np.float32)
    mask = np.ones((B, L), bool)
    mask[1, -4:] = False
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    jm = jt.CrossAttnTransformer(n_token=3, H=4, D=D, D_k=8, D_v=8,
                                 D_inner=64)
    params, _ = _jax_variables(jm, jnp.asarray(x))
    # a non-trivial LayerNorm affine
    params = jax.tree_util.tree_map(np.asarray, params)
    params["crs_attn"]["layer_norm"]["scale"] = rng.uniform(
        0.5, 1.5, D).astype(np.float32)
    params["mlp"]["layer_norm"]["bias"] = rng.normal(
        0, 0.1, D).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x), jmask)
    ref_s = jm.apply({"params": params}, jnp.asarray(x), jmask,
                     method=jt.CrossAttnTransformer.get_scores)
    tm = tt.CrossAttnTransformer(3, 4, D, 8, 8, 64)
    weights.load_jax(tm, params, {})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), tmask)
        got_s = tm.get_scores(torch.from_numpy(x), tmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def tiny_models():
    jconf = j_config(dict(TINY))
    model, params, stats = init_ips_model(jconf, jax.random.PRNGKey(0))
    stats = _perturb_stats(stats, np.random.default_rng(5))
    tm = TModel(t_config(dict(TINY))).eval()
    weights.load_jax(tm, params, stats)
    return model, {"params": params, "batch_stats": stats}, tm


@pytest.mark.parametrize("score_impl", ["attn", "fast", "pallas"])
def test_ips_model_scores(tiny_models, score_impl):
    jmodel, variables, tm = tiny_models
    emb = np.random.default_rng(6).standard_normal((2, 7, 128), np.float32)
    mask = np.ones((2, 7), bool)
    mask[0, 5:] = False
    ref = jmodel.apply(variables, jnp.asarray(emb), jnp.asarray(mask),
                       method=JModel.scores)
    tm.conf.score_impl = score_impl
    try:
        with torch.no_grad():
            got = tm.scores(torch.from_numpy(emb), torch.from_numpy(mask))
    finally:
        tm.conf.score_impl = "fast"
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_ips_model_forward_matches_flax(tiny_models):
    jmodel, variables, tm = tiny_models
    rng = np.random.default_rng(7)
    patches = rng.random((2, 4, 16, 16, 1), np.float32)
    pos = 0.1 * rng.standard_normal((2, 4, 128), np.float32)
    ref = jmodel.apply(variables, jnp.asarray(patches), jnp.asarray(pos),
                       None, train=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(patches), torch.from_numpy(pos))
        enc = tm.encode(torch.from_numpy(patches))
    ref_enc = jmodel.apply(variables, jnp.asarray(patches),
                           method=JModel.encode)
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), **TOL)
    for name in ("majority", "multi"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                                   **TOL)


def test_uint8_and_imagenet_encode():
    conf = dict(TINY, n_chan_in=3, input_norm="imagenet")
    jconf = j_config(dict(conf))
    jmodel, params, stats = init_ips_model(jconf, jax.random.PRNGKey(1))
    tm = TModel(t_config(dict(conf))).eval()
    weights.load_jax(tm, params, stats)
    x = np.random.default_rng(8).integers(0, 256, (1, 3, 16, 16, 3),
                                          dtype=np.uint8)
    ref = jmodel.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), method=JModel.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bridge_round_trip(tiny_models, tmp_path):
    _, variables, tm = tiny_models
    flat = weights.to_flat(tm)
    ref = weights.flatten_variables(variables["params"],
                                    variables["batch_stats"])
    assert set(flat) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(flat[k], np.asarray(ref[k]), err_msg=k)
    other = TModel(t_config(dict(TINY)))
    init_weights(other, torch.Generator().manual_seed(3))
    path = str(tmp_path / "w.npz")
    weights.save_npz(tm, path)
    weights.load_flat(other, path)
    for (k, a), (_, b) in zip(tm.state_dict().items(),
                              other.state_dict().items()):
        assert torch.equal(a, b), k


def test_bridge_rejects_missing_and_unused_keys(tiny_models):
    _, _, tm = tiny_models
    flat = weights.to_flat(tm)
    missing = dict(flat)
    missing.pop("params/transf/crs_attn/q")
    with pytest.raises(KeyError, match="missing"):
        weights.load_flat(tm, missing)
    extra = dict(flat)
    extra["params/encoder/extra/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="no counterpart"):
        weights.load_flat(tm, extra)
    bad = dict(flat)
    bad["params/head_majority/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        weights.load_flat(tm, bad)


def test_init_is_seeded_and_leaves_global_rng():
    from ips_tpu_torch.train.steps import IPSTrainer
    conf = t_config(dict(TINY))
    torch.manual_seed(123)
    expected = torch.rand(3)
    torch.manual_seed(123)
    a = IPSTrainer(conf, device="cpu").model.state_dict()
    assert torch.equal(torch.rand(3), expected)
    b = IPSTrainer(conf, device="cpu").model.state_dict()
    c = IPSTrainer(conf.replace(seed=1), device="cpu").model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv1.weight"],
                           c["encoder.conv1.weight"])
    std = a["encoder.conv1.weight"].std().item()
    assert abs(std - (2.0 / (64 * 49)) ** 0.5) < 0.1 * std
