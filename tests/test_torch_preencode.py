"""The port's pre-encoded and pre-permuted selection against ips_tpu's.

``ips_select`` with ``preencode`` (one encode of all N), with
``preencode_chunked`` (contiguous I-slices, N not a multiple of I, so the
table is padded and cut back) and with ``prepermute``, on the same numpy
inputs in both packages, masks and a positional table included: with a
linear stub encoder and with the tiny conv encoder of test_torch_infer.py
(perturbed running statistics, weights bridged from JAX). Bounds: kept
indices, masks and patches equal; embeddings within EMB_TOL (fp32, the
same encoder in both). Each variant also keeps the port's own per-chunk
indices.

``IPSTrainer._resolve_preencode`` (what ``preencode_select='auto'``
turns into) is held equal to the JAX trainer's on a grid of shapes and
dtypes: both sides of the 96 MiB table, M >= N, the MNIST and camelyon
shapes, and the assembled callers' stacked (r * B_seq, N, ...) table.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.ops import score_kernel as jsk
from ips_tpu.ops.selection import ips_select as j_select
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.ops import score_kernel as tsk
from ips_tpu_torch.ops.selection import ips_select as t_select
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_infer import TINY, _perturb_stats
from test_torch_selection import _problem

EMB_TOL = dict(rtol=1e-5, atol=1e-5)
VARIANTS = {"preencode": dict(preencode=True),
            "preencode_chunked": dict(preencode=True, preencode_chunked=True),
            "prepermute": dict(prepermute=True)}
CONV = dict(TINY, shuffle=False)


def _mask(B, N):
    mask = np.ones((B, N), bool)
    mask[1, -5:] = False
    if B > 2:
        mask[2, ::3] = False
    return mask


def _assert_same(t, j, per_chunk):
    np.testing.assert_array_equal(t.mem_idx.numpy(), np.asarray(j.mem_idx))
    np.testing.assert_array_equal(t.mem_mask.numpy(),
                                  np.asarray(j.mem_mask))
    np.testing.assert_array_equal(t.mem_patch.numpy(),
                                  np.asarray(j.mem_patch))
    np.testing.assert_allclose(t.mem_emb.numpy(), np.asarray(j.mem_emb),
                               **EMB_TOL)
    np.testing.assert_array_equal(t.mem_idx.numpy(),
                                  per_chunk.mem_idx.numpy())


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("N,M,I", [(23, 5, 4), (40, 8, 8), (17, 6, 5)])
@pytest.mark.parametrize("use_mask", [False, True], ids=["full", "masked"])
def test_stub_encoder_matches_jax(variant, N, M, I, use_mask):
    B = 3
    patches, proj, w_eff, pos = _problem(B, N, N * 5 + M)
    mask = _mask(B, N) if use_mask else None
    kw = VARIANTS[variant]
    jp, jw = jnp.asarray(proj), jnp.asarray(w_eff)
    j = j_select(lambda x: x @ jp, lambda e, m: jsk.fast_scores(e, jw, m),
                 jnp.asarray(patches), M=M, I=I, pos_table=jnp.asarray(pos),
                 mask=None if mask is None else jnp.asarray(mask),
                 return_emb=True, **kw)
    tp, tw = torch.from_numpy(proj), torch.from_numpy(w_eff)
    encoded = []

    def encode(x):
        encoded.append(x.shape[1])
        return x @ tp

    args = (encode, lambda e, m: tsk.scores(e, tw, m),
            torch.from_numpy(patches))
    opts = dict(M=M, I=I, pos_table=torch.from_numpy(pos),
                mask=None if mask is None else torch.from_numpy(mask),
                return_emb=True)
    t = t_select(*args, **opts, **kw)
    if variant == "preencode_chunked":
        # whole I-slices of the padded table, cut back to N
        assert encoded == [I] * (-(-N // I))
    elif variant == "preencode":
        assert encoded == [N]
    _assert_same(t, j, t_select(*args, **opts))


@pytest.fixture(scope="module")
def conv_pair():
    """The tiny conv model in both packages, the same weights and
    perturbed running statistics."""
    jtr = JTrainer(j_config(CONV), rng=jax.random.PRNGKey(0), init_opt=False)
    stats = _perturb_stats(jtr.state.batch_stats, np.random.default_rng(1))
    jtr.state = jtr.state.replace(
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    port = IPSTrainer(t_config(CONV), device="cpu", init_opt=False)
    weights.load_jax(port.model, jtr.state.params, jtr.state.batch_stats)
    return jtr, port


def _conv_inputs(seed, B=3, N=23):
    rng = np.random.default_rng(seed)
    x = rng.random((B, N, 16, 16, 1), np.float32)
    x[:, rng.random(N) < 0.4] = 0.0
    return x, _mask(B, N)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_conv_encoder_matches_jax(conv_pair, variant):
    """N = 23, M = 4, I = 5: the chunked table is padded to 25 rows."""
    jtr, port = conv_pair
    x, mask = _conv_inputs(4)
    conf = port.conf
    j_enc, j_score = jtr._enc_score_fns(jtr.state.params,
                                        jtr.state.batch_stats)
    j = j_select(j_enc, j_score, jnp.asarray(x), M=conf.M, I=conf.I,
                 pos_table=jnp.asarray(jtr.pos_table),
                 mask=jnp.asarray(mask), return_emb=True,
                 **VARIANTS[variant])
    enc, score = port._enc_score_fns()
    with torch.no_grad():
        args = (enc, score, torch.from_numpy(x))
        opts = dict(M=conf.M, I=conf.I, pos_table=port.pos_table,
                    mask=torch.from_numpy(mask), return_emb=True)
        _assert_same(t_select(*args, **opts, **VARIANTS[variant]), j,
                     t_select(*args, **opts))


def test_preencode_select_true_matches_jax(conv_pair):
    """``preencode_select=true`` through each trainer's ``select``: the
    chunked pre-encode (a conv encoder) in both, the same kept set."""
    jtr0, port0 = conv_pair
    over = dict(CONV, preencode_select=True)
    jtr = JTrainer(j_config(over), rng=jax.random.PRNGKey(0), init_opt=False)
    jtr.state = jtr0.state
    port = IPSTrainer(t_config(over), device="cpu", init_opt=False)
    port.model.load_state_dict(port0.model.state_dict())
    x, mask = _conv_inputs(5)
    j = jtr.select(jnp.asarray(x), jnp.asarray(mask))
    t = port.select(torch.from_numpy(x), torch.from_numpy(mask))
    for got, want in zip(t, j):
        if want is not None:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **EMB_TOL)
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    per_chunk = port0.select(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(t[2].numpy(), per_chunk[2].numpy())


# ------------------------------------------------------------ resolution
MIB = 2**20
SHAPES = [
    ((16, 900, 50, 50, 1), "bfloat16"),    # MNIST selection: 68.7 MiB
    ((16, 900, 50, 50, 1), "float32"),     # the same before its cast
    ((1, 10000, 2048), "float32"),         # one camelyon slide: 78.1 MiB
    ((16, 10000, 2048), "float32"),        # r = 16 of them stacked
    ((1, 12288, 2048), "float32"),         # exactly 96 MiB: stays off
    ((1, 12289, 2048), "float32"),         # one row more
    ((1, 2304, 224, 224, 3), "uint8"),     # a camelyon_e2e slide
    ((8, 256, 224, 224, 3), "uint8"),      # M >= N at M = 256
    ((3, 7, 8), "float32")]


def _resolvers(pe, M):
    d = dict(CONV, M=M, I=M, preencode_select=pe)
    return (types.SimpleNamespace(conf=j_config(d)),
            types.SimpleNamespace(conf=t_config(d)))


@pytest.mark.parametrize("pe", ["auto", True, False])
@pytest.mark.parametrize("M", [4, 256, 5000])
def test_resolve_preencode_matches_jax(pe, M):
    jself, tself = _resolvers(pe, M)
    got, want = [], []
    for shape, dt in SHAPES:
        want.append(JTrainer._resolve_preencode(
            jself, jax.ShapeDtypeStruct(shape, jnp.dtype(dt))))
        got.append(IPSTrainer._resolve_preencode(
            tself, shape, getattr(torch, dt)))
    assert got == want
    if pe == "auto" and M == 256:
        assert want == [False, True, False, True, False, True, True, False,
                        False]


@pytest.mark.parametrize("input_dtype", ["float32", "bfloat16"])
def test_assembled_resolves_on_the_stacked_table(input_dtype):
    """``_select_slots`` resolves 'auto' once on the (r * B_seq, N, ...)
    table as it arrives, before the input cast, as the JAX package's
    ``_fused_assembled_impl`` (steps.py:668-675) and its eval
    (:706-711) do; each slot alone would resolve otherwise."""
    c = dict(CONV, is_image=False, n_chan_in=2048, use_pos=False, N=0, M=5000,
             I=5000, B=16, B_seq=1, input_dtype=input_dtype)
    port = IPSTrainer(t_config(dict(c, D=16, D_k=4, D_v=4, D_inner=16)),
                      device="cpu", init_opt=False)
    seen = []
    port._select_impl = lambda p, m, g, return_emb=False, preencode=None: (
        seen.append((tuple(p.shape), preencode)) or (p[:, :1],) * 4)
    # the shape without the bytes: r = 16 slots of one 10000-row slide
    patches = torch.zeros(()).expand(16, 1, 10000, 2048)
    port._select_slots(patches, None, None)
    total = JTrainer._resolve_preencode(
        types.SimpleNamespace(conf=j_config(c)),
        jax.ShapeDtypeStruct((16, 10000, 2048), jnp.float32))
    one = JTrainer._resolve_preencode(
        types.SimpleNamespace(conf=j_config(c)),
        jax.ShapeDtypeStruct((1, 10000, 2048), jnp.float32))
    assert (total, one) == (True, False)
    assert seen == [((1, 10000, 2048), total)] * 16
