"""The port's int8 selection encoder (models/quant.py, ``select_dtype:
int8``) against ips_tpu/models/quant.py.

Stated tolerances, with the values measured on this CPU:

  * ``_quant_act``, ``_quant_kernel`` and the int8 convolution's int32
    sums: bitwise (measured: equal).
  * ``quant_encode_patches``: rtol 1e-5 / atol 1e-5 elementwise. The two
    take the global mean and the folded BatchNorm's products in another
    order, an ulp apart; an ulp can move a later layer's quantized value
    by one int8 step (1/127 of that tensor's max), which would show as
    ~1e-3 relative. Measured: max |diff| 2.4e-6 on embeddings up to 8.7
    (ResNet-50/2), relative Frobenius distance <= 1.6e-7 on every
    encoder below: no quantized value moved.
  * int8 selection: the same kept indices as JAX's int8 selection, in
    the same order, at the tiny config and from the trained 150-epoch
    weights at the shipped MNIST width (B = 2); a difference would be
    allowed only at a near-tie, which neither case shows (measured: equal).
  * ``fused_step`` with int8 selection: test_torch_train.py's bounds.
"""

import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.models import quant as jq
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.models import quant as tq
from ips_tpu_torch.models.encoders import ConvPatchEncoder
from ips_tpu_torch.models.ips_net import init_weights
from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.train.steps import IPSTrainer

import test_torch_train as ttt
from test_torch_infer import TINY, _inputs, _perturb_stats

ENC_TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0], ids=["unit", "small",
                                                         "zero"])
def test_quant_act_matches_jax(scale):
    x = (np.random.default_rng(0).standard_normal((4, 9, 9, 16))
         * scale).astype(np.float32)
    q, s = tq._quant_act(torch.from_numpy(x))
    jq_, js = jq._quant_act(jnp.asarray(x))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    assert s.item() == float(js)


def test_quant_act_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    q, s = tq._quant_act(x)
    assert s.item() == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -2]
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jq._quant_act(x.numpy())[0]))


def test_quant_kernel_matches_jax():
    k = (np.random.default_rng(1).standard_normal((3, 3, 16, 8)) * 0.2
         ).astype(np.float32)
    k[..., 3] = 0.0                              # an all-zero out channel
    q, s = tq._quant_kernel(torch.from_numpy(k).permute(3, 2, 0, 1))
    jq_, js = jq._quant_kernel(jnp.asarray(k))
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("k,c_in,c_out,stride,pad", [
    (7, 1, 64, 2, 3), (7, 3, 64, 2, 3), (3, 64, 64, 1, 1),
    (3, 64, 128, 2, 1), (1, 64, 128, 2, 0), (1, 64, 256, 1, 0)],
    ids=["stem_c1", "stem_c3", "3x3s1", "3x3s2", "1x1s2_downsample",
         "1x1s1_bottleneck"])
def test_int8_conv_sums_match_jax(k, c_in, c_out, stride, pad):
    """int32 accumulations bitwise equal to lax.conv_general_dilated's."""
    rng = np.random.default_rng(k + c_in + stride)
    xq = rng.integers(-127, 128, (2, 13, 11, c_in)).astype(np.int8)
    kq = rng.integers(-127, 128, (k, k, c_in, c_out)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=dn,
        preferred_element_type=jnp.int32)
    got = tq.int8_conv(torch.from_numpy(xq),
                       torch.from_numpy(kq).permute(3, 2, 0, 1), stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- encoder
def _random_encoder(enc_type, n_chan_in, n_blocks, seed=0):
    enc = ConvPatchEncoder(enc_type, n_chan_in, n_blocks)
    gen = torch.Generator().manual_seed(seed)
    init_weights(enc, gen)
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.weight.shape[0]
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, n)),
                             (m.bias, rng.normal(0, 0.2, n)),
                             (m.running_mean, rng.normal(0, 0.2, n)),
                             (m.running_var, rng.uniform(0.5, 2.0, n))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return enc


def _jax_trees(module):
    """The port module's weights as the reference's nested trees."""
    trees = {"params": {}, "batch_stats": {}}
    for key, v in weights.to_flat(module).items():
        coll, *path = key.split("/")
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    return trees["params"], trees["batch_stats"]


@pytest.mark.parametrize("enc_type,n_blocks,hw,c,input_norm", [
    ("resnet18", 2, 50, 1, "none"), ("resnet18", 4, 32, 1, "none"),
    ("resnet50", 2, 16, 1, "none"), ("resnet18", 2, 32, 3, "imagenet")],
    ids=["r18_2", "r18_4", "r50_2", "uint8_imagenet"])
def test_quant_encode_matches_jax(enc_type, n_blocks, hw, c, input_norm):
    enc = _random_encoder(enc_type, c, n_blocks)
    params, stats = _jax_trees(enc)
    rng = np.random.default_rng(2)
    x = rng.random((3, hw, hw, c), np.float32)
    if input_norm == "imagenet":
        x = (x * 255).astype(np.uint8)
    f = jax.jit(lambda p, s, v: jq.quant_encode_patches(
        p, s, v, enc_type=enc_type, n_res_blocks=n_blocks,
        input_norm=input_norm))
    want = np.asarray(f(params, stats, jnp.asarray(x)))
    got = tq.quant_encode_patches(enc, torch.from_numpy(x), input_norm)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **ENC_TOL)
    # and it tracks the fp32 encoder (selection ranks by it)
    with torch.no_grad():
        xf = torch.from_numpy(x).float()
        if input_norm == "imagenet":
            xf = xf / 255.0
            from ips_tpu_torch.utils.imagenet import (IMAGENET_MEAN,
                                                      IMAGENET_STD)
            xf = (xf - torch.from_numpy(IMAGENET_MEAN)) / torch.from_numpy(
                IMAGENET_STD)
        full = enc(xf).numpy()
    cos = (got.numpy() * full).sum(1) / (
        np.linalg.norm(got.numpy(), axis=1) * np.linalg.norm(full, axis=1))
    assert cos.min() > 0.98, cos


# -------------------------------------------------------------- selection
def _jax_tiny(**over):
    tr = JTrainer(j_config(dict(TINY, **over)), rng=jax.random.PRNGKey(0),
                  init_opt=False)
    stats = _perturb_stats(tr.state.batch_stats, np.random.default_rng(1))
    tr.state = tr.state.replace(
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    return tr


def test_int8_select_matches_jax_tiny():
    jtr = _jax_tiny(select_dtype="int8", shuffle=False)
    tr = IPSTrainer(t_config(dict(TINY, select_dtype="int8", shuffle=False)),
                    device="cpu", init_opt=False)
    weights.load_jax(tr.model, jtr.state.params, jtr.state.batch_stats)
    x = _inputs(7, B=2)
    mask = np.ones((2, TINY["N"]), bool)
    mask[1, -5:] = False
    for m in (None, mask):
        want = np.asarray(jtr.select(jnp.asarray(x), None if m is None
                                     else jnp.asarray(m))[2])
        got = tr.select(torch.from_numpy(x),
                        None if m is None else torch.from_numpy(m))[2]
        np.testing.assert_array_equal(got.numpy(), want)
    enc, _ = tr._enc_score_fns()
    assert enc.__qualname__.startswith("make_quant_encode_fn")
    fp = IPSTrainer(t_config(dict(TINY)), device="cpu", init_opt=False)
    assert fp._enc_score_fns()[0] == fp.model.encode


def test_int8_select_from_trained_weights(tmp_path):
    """ips_tpu's 150-epoch MNIST checkpoint, restored by ips_tpu and
    bridged into the port; both int8 selections at the shipped width on
    two generated test images."""
    from ips_tpu.config import load_config as j_load
    from ips_tpu.data.mnist import MegapixelMNIST, generate_megapixel_mnist
    from ips_tpu.utils.checkpoint import CheckpointManager
    from ips_tpu_torch.config import load_config as t_load
    data_dir = str(tmp_path / "mnist")
    generate_megapixel_mnist(data_dir, n_train=1, n_test=2, seed=0,
                             digit_source="sklearn")
    cfg = os.path.join(ROOT, "config", "mnist_config.yml")
    over = [f"data_dir={data_dir}", "sparse_input=false", "select_dtype=int8",
            "shuffle=false"]
    conf = j_load(cfg, over)
    ckpt = tmp_path / "ckpt"
    shutil.copytree(os.path.join(ROOT, "ckpt_mnist150", "150"), ckpt / "150")
    jtr = JTrainer(conf, rng=jax.random.PRNGKey(0))
    assert CheckpointManager(str(ckpt)).restore(jtr) == 150
    ds = MegapixelMNIST(conf, train=False)
    x = np.stack([ds[i]["input"] for i in range(2)]).astype(np.float32)
    assert x.shape == (2, 900, 50, 50, 1)
    t0 = time.perf_counter()
    want = np.asarray(jtr.select(jnp.asarray(x))[2])
    t1 = time.perf_counter()
    tr = IPSTrainer(t_load(cfg, over), device="cpu", init_opt=False)
    weights.load_jax(tr.model, jtr.state.params, jtr.state.batch_stats)
    got = tr.select(torch.from_numpy(x))[2].numpy()
    print(f"jax {t1 - t0:.1f} s, port {time.perf_counter() - t1:.1f} s")
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- training
def test_fused_step_int8_matches_jax():
    """3 fused steps at lr 1e-3 with int8 selection from the perturbed
    initial state, held as test_torch_train.py's fp32 steps are."""
    jtr = ttt.jax_trainer(select_dtype="int8")
    outs, states = ttt.run_jax(jtr, ttt.step_batches())
    port = ttt.port_trainer(states[0], select_dtype="int8")
    for k, step in enumerate(ttt.step_batches()):
        got = port.fused_step(*ttt.to_torch(*step), None, ttt.LR)
        ttt.assert_outputs_close(got, outs[k])
        if k == 0:
            ttt.assert_grads_close(port, states[1].opt_state)
            ttt.assert_state_close(port, states[1], 1)
    ttt.assert_state_close(port, states[3], 3)


def test_int8_config_rules():
    with pytest.raises(ValueError, match="select_dtype"):
        t_config(dict(TINY, select_dtype="int4"))
    with pytest.raises(ValueError, match="projector"):
        t_config(dict(TINY, select_dtype="int8", is_image=False,
                      n_chan_in=32))
    # embedding reuse stays off: the int8 buffer is not the fp encoder's
    tr = IPSTrainer(t_config(dict(TINY, select_dtype="int8")), device="cpu",
                    init_opt=False)
    assert not tr._reuse_eval_emb()
