"""The port's pretrained weights (``ips_tpu_torch.models.pretrained``) and
ResNet-50 at full depth against ips_tpu's.

- conversion: the manifest, the schema errors and ``torch_resnet_to_flat``
  key for key, bitwise (the same npz payload either package writes);
- loading: one converted npz gives the same encoder outputs in both
  packages (fp32 within rtol 1e-4; bf16 within a relative Frobenius
  distance of 1e-2), with JAX's cover / skip / mismatch errors;
- ``IPSTrainer(pretrained=true)``: full cover, the stem skip for a
  1-channel input, the missing path.

ResNet-50 with 4 stages (2048-d) runs on a few 32x32 tiles; its two JAX
functions (fp32, bf16) are compiled once for the module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.models import pretrained as jp
from ips_tpu.models.encoders import ConvPatchEncoder as JEncoder
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.models import pretrained as tp
from ips_tpu_torch.models.encoders import ConvPatchEncoder
from ips_tpu_torch.train.steps import IPSTrainer

# fp32: the same products summed in another order (measured 6.8e-7
# relative over 53 convs); bf16: both round the same tensors to bf16, and
# a sum on the other side of a rounding boundary moves a value by one bf16
# ulp, which the later convs carry (measured 4.4e-3)
FP32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 1e-2


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _state(enc_type="resnet50", seed=0):
    return tp.seeded_state_dict(enc_type, seed)


# ------------------------------------------------------------ conversion
@pytest.mark.parametrize("enc_type", ["resnet18", "resnet50"])
def test_manifest_equals_jax(enc_type):
    assert tp.torchvision_manifest(enc_type) == jp.torchvision_manifest(
        enc_type)
    assert len(tp.torchvision_manifest(enc_type)) == {
        "resnet18": 122, "resnet50": 320}[enc_type]


def test_seeded_state_dict_passes_the_full_schema():
    sd = _state()
    tp.verify_torchvision_state_dict(sd, "resnet50")
    jp.verify_torchvision_state_dict(sd, "resnet50")
    assert all(np.array_equal(sd[k], v) for k, v in _state().items())


@pytest.mark.parametrize("enc_type,verify", [
    ("resnet18", "full"), ("resnet50", "full"), ("resnet50", "truncated"),
    ("resnet50", "none")])
def test_flat_equals_jax_bitwise(enc_type, verify):
    sd = _state(enc_type, 3)
    if verify == "truncated":               # whole stages absent
        sd = {k: v for k, v in sd.items()
              if not k.startswith(("layer3.", "layer4.", "fc."))}
    got = tp.torch_resnet_to_flat(sd, enc_type, verify=verify)
    want = jp.torch_resnet_to_flat(sd, enc_type, verify=verify)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    # torch tensors convert as numpy arrays do
    from_torch = tp.torch_resnet_to_flat(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        enc_type, verify=verify)
    assert all(np.array_equal(from_torch[k], want[k]) for k in want)


def _drop_block(sd, pre):
    return {k: v for k, v in sd.items() if not k.startswith(pre)}


@pytest.mark.parametrize("case,verify,match", [
    ("missing", "full", "missing.*layer2.1.conv2"),
    ("missing", "truncated", "partially present"),
    ("unexpected", "truncated", "unexpected"),
    ("shape", "truncated", "shape mismatches"),
    ("verify_arg", "sometimes", "verify must be"),
])
def test_schema_errors_as_jax(case, verify, match):
    sd = dict(_state("resnet18", 1))
    if case == "missing":
        del sd["layer2.1.conv2.weight"]
    elif case == "unexpected":
        sd["module.backbone.junk"] = np.zeros((3,), np.float32)
    elif case == "shape":
        sd["layer1.0.conv1.weight"] = np.zeros((64, 64, 5, 5), np.float32)
    for mod in (tp, jp):
        with pytest.raises(ValueError, match=match):
            mod.torch_resnet_to_flat(sd, "resnet18", verify=verify)


def test_cli_converts_a_torch_checkpoint(tmp_path):
    sd = {k: torch.from_numpy(np.asarray(v)) for k, v in _state().items()}
    ckpt = tmp_path / "r50.pth"
    torch.save({"state_dict": sd}, ckpt)
    tp.main(["--enc_type", "resnet50", str(ckpt), str(tmp_path / "w.npz")])
    with np.load(tmp_path / "w.npz") as z:
        want = jp.torch_resnet_to_flat(_state(), "resnet50")
        assert sorted(z.files) == sorted(want)
        assert all(np.array_equal(z[k], want[k]) for k in want)


# --------------------------------------------------------------- loading
@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pretrained") / "r50.npz")
    tp.save_npz(path, tp.torch_resnet_to_flat(_state(), "resnet50"))
    return path


@pytest.fixture(scope="module")
def jax_r50(npz):
    """JAX ResNet-50/4 features of a few tiles at the npz's weights, fp32
    and bf16, each function compiled once."""
    x = np.random.default_rng(0).integers(
        0, 256, (4, 32, 32, 3)).astype(np.float32) / 255.0
    out = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        m = JEncoder(enc_type="resnet50", n_chan_in=3, n_res_blocks=4,
                     dtype=dt)
        v = jax.jit(lambda k: m.init(k, jnp.zeros((1, 32, 32, 3)),
                                     train=False))(jax.random.PRNGKey(0))
        v = jp.load_encoder_npz(npz, v, expect_cover=True)
        out[name] = np.asarray(jax.jit(
            lambda v, x: m.apply(v, x, train=False))(v, jnp.asarray(x)))
    return x, out


def _port_r50(npz, x, dtype=torch.float32, **kw):
    enc = ConvPatchEncoder("resnet50", 3, 4, dtype=dtype).eval()
    tp.load_encoder_npz(npz, enc, expect_cover=True, **kw)
    with torch.no_grad():
        return enc(torch.from_numpy(x)).numpy()


def test_resnet50_full_depth_fp32_matches_jax(npz, jax_r50):
    x, want = jax_r50
    got = _port_r50(npz, x)
    assert got.shape == (4, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want["float32"], **FP32)


def test_resnet50_full_depth_bf16_matches_jax(npz, jax_r50):
    x, want = jax_r50
    got = _port_r50(npz, x, torch.bfloat16)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _rel(got, want["bfloat16"]) < BF16_REL


def test_loaded_tensors_are_the_checkpoint(npz):
    sd = _state()
    enc = tp.load_encoder_npz(npz, ConvPatchEncoder("resnet50", 3, 4))
    np.testing.assert_array_equal(enc.conv1.weight.detach().numpy(),
                                  sd["conv1.weight"])
    blk = enc.layer4_block2
    np.testing.assert_array_equal(blk.conv3.weight.detach().numpy(),
                                  sd["layer4.2.conv3.weight"])
    np.testing.assert_array_equal(blk.bn3.running_var.numpy(),
                                  sd["layer4.2.bn3.running_var"])
    np.testing.assert_array_equal(
        enc.layer1_block0.downsample_bn.weight.detach().numpy(),
        sd["layer1.0.downsample.1.weight"])


def _r18_npz(tmp_path, drop=None):
    sd = _state("resnet18", 2)
    verify = "full"
    if drop:
        sd, verify = _drop_block(sd, drop), "truncated"
    path = str(tmp_path / "r18.npz")
    tp.save_npz(path, tp.torch_resnet_to_flat(sd, "resnet18", verify=verify))
    return path, sd


def _jax_r18_vars(n_chan_in=3, n_res_blocks=2):
    m = JEncoder(enc_type="resnet18", n_chan_in=n_chan_in,
                 n_res_blocks=n_res_blocks)
    return m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, n_chan_in)),
                  train=False)


@pytest.mark.parametrize("case,kw,match", [
    ("stem_1ch", {}, "shape mismatch"),
    ("partial", {"expect_cover": True}, "not covered"),
    ("bogus", {}, "no keys"),
    ("on_mismatch", {"on_mismatch": "sometimes"}, "on_mismatch must be"),
])
def test_load_errors_as_jax(tmp_path, case, kw, match):
    path, _ = _r18_npz(tmp_path, drop="layer2.1." if case == "partial"
                       else None)
    if case == "bogus":
        path = str(tmp_path / "bogus.npz")
        np.savez(path, **{"params/bogus/kernel": np.zeros((3, 3))})
    n_chan_in = 1 if case == "stem_1ch" else 3
    with pytest.raises(ValueError, match=match):
        jp.load_encoder_npz(path, _jax_r18_vars(n_chan_in), **kw)
    with pytest.raises(ValueError, match=match):
        tp.load_encoder_npz(path, ConvPatchEncoder("resnet18", n_chan_in, 2),
                            **kw)


def test_skip_semantics_as_jax(tmp_path):
    """The stem skip keeps the initial stem and loads the rest with full
    cover; ``on_mismatch='skip'`` skips silently; without
    ``expect_cover`` a partial npz loads what it has."""
    path, sd = _r18_npz(tmp_path)
    enc = ConvPatchEncoder("resnet18", 1, 2)
    stem = enc.conv1.weight.detach().clone()
    tp.load_encoder_npz(path, enc, skip_keys=("params/conv1/kernel",),
                        expect_cover=True)
    assert torch.equal(enc.conv1.weight, stem)
    np.testing.assert_array_equal(enc.bn1.running_mean.numpy(),
                                  sd["bn1.running_mean"])
    enc2 = ConvPatchEncoder("resnet18", 1, 2)
    stem2 = enc2.conv1.weight.detach().clone()
    tp.load_encoder_npz(path, enc2, on_mismatch="skip")
    assert torch.equal(enc2.conv1.weight, stem2)
    np.testing.assert_array_equal(
        enc2.layer1_block0.conv1.weight.detach().numpy(),
        sd["layer1.0.conv1.weight"])
    part, _ = _r18_npz(tmp_path, drop="layer2.1.")
    tp.load_encoder_npz(part, ConvPatchEncoder("resnet18", 3, 2))


# --------------------------------------------------------------- trainer
TASKS = {"task0": {"id": 0, "name": "metastases", "act_fn": "sigmoid",
                   "metric": "auc"}}


def _conf(**over):
    d = dict(B=2, B_seq=2, n_class=1, is_image=True, enc_type="resnet18",
             n_chan_in=3, n_res_blocks=2, n_token=1, N=8, M=2, I=2,
             patch_size=[32, 32], patch_stride=[32, 32], use_pos=False,
             H=2, D=128, D_k=8, D_v=8, D_inner=32, compute_dtype="float32",
             tasks=TASKS, pretrained=True)
    d.update(over)
    return d


@pytest.mark.parametrize("n_chan_in", [3, 1])
def test_trainer_pretrained_matches_jax(tmp_path, n_chan_in):
    path, sd = _r18_npz(tmp_path)
    d = _conf(n_chan_in=n_chan_in, pretrained_path=path)
    jt = JTrainer(j_config(d), init_opt=False)
    tt = IPSTrainer(t_config(d), device="cpu", init_opt=False)
    enc = tt.model.encoder
    # every loaded tensor equals JAX's; the stem of a 1-channel input
    # keeps its initial values in both
    flat = weights.flatten_variables(jt.state.params, jt.state.batch_stats)
    want = {k: v for k, v in flat.items() if k.split("/")[1] == "encoder"}
    got = weights.to_flat(tt.model)
    for k, v in want.items():
        if k == "params/encoder/conv1/kernel" and n_chan_in != 3:
            assert v.shape == (7, 7, 1, 64) and got[k].shape == v.shape
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if n_chan_in == 3:
        np.testing.assert_array_equal(
            enc.conv1.weight.detach().numpy(), sd["conv1.weight"])


def test_trainer_pretrained_errors(tmp_path):
    for mod, cfg in ((None, t_config), (JTrainer, j_config)):
        with pytest.raises(ValueError, match="requires pretrained_path"):
            if mod is None:
                IPSTrainer(cfg(_conf()), device="cpu")
            else:
                mod(cfg(_conf()))
    part, _ = _r18_npz(tmp_path, drop="layer2.1.")
    with pytest.raises(ValueError, match="not covered"):
        IPSTrainer(t_config(_conf(pretrained_path=part)), device="cpu")
    # feature mode ignores the flag, as the JAX package does
    feat = _conf(is_image=False, n_chan_in=16, D=16, patch_size=None,
                 patch_stride=None)
    IPSTrainer(t_config(feat), device="cpu", init_opt=False)
