"""The slice in bf16 compute: the port's Predictor against
ips_tpu.infer.Predictor with compute_dtype = input_dtype = "bfloat16",
the dtypes of the main path (config/mnist_config.yml).

The same numpy-seeded weights (BatchNorm statistics perturbed so they
matter) and inputs go to both. Both round the same tensors to bf16 at the
same places (flax's Conv and Dense cast inputs and kernels to the compute
dtype and accumulate in fp32, as the port's Conv.forward and dense do);
what differs is the order of fp32 sums inside each product and XLA's
against PyTorch's convolution algorithms. A sum that lands on the other
side of a bf16 rounding boundary moves that value by one bf16 ulp
(2^-8 relative), and such flips pass through the encoder's five convs
and the transformer. So:

- selected indices must be equal, or else every swapped candidate must be
  a near-tie: its score within SCORE_GAP of the M-th kept score, in the
  reference's own scores (the gap is printed);
- probabilities agree within PROB_ATOL = 2^-7 absolute, two bf16 ulps
  of a probability near 1: the heads see activations that may differ by
  such flips, and the softmax or sigmoid passes a logit error on at a
  slope of at most 1/4 (measured: at most 1.4e-3).

The probabilities alone cannot tell a missing cast: with these small
random weights the port computing everything in fp32 also lands within
1.6e-3 of the bf16 reference. So each stage is held on its own, by the
relative Frobenius distance of its output from the reference's: a stage
that rounds where the reference rounds differs only by the occasional
flip, while the same stage left in fp32 misses every rounding, about
2^-8/sqrt(12) relative per rounded tensor. The stated bounds sit between
the two (measured on the inputs below: encoder 4.8e-5 to 1.4e-4 in bf16
against 1.8e-3 in fp32; aggregation transformer 5.6e-8 against 3.5e-3,
since each projection rounds its product to bf16 before adding the bias,
as flax's Dense does), and each test also asserts that the fp32 stage
exceeds its bound, so that the check is shown to catch a missing cast.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.config import config_from_dict as j_config
from ips_tpu.infer import Predictor as JPredictor
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.infer import Predictor
from ips_tpu_torch.models.encoders import Conv

TINY = dict(
    B=2, B_seq=2, n_class=10, is_image=True, enc_type="resnet18",
    n_chan_in=1, n_res_blocks=2, n_token=2, N=23, M=4, I=5,
    patch_size=[16, 16], patch_stride=[16, 16], use_pos=True, H=4, D=128,
    D_k=16, D_v=16, D_inner=256, compute_dtype="bfloat16",
    input_dtype="bfloat16",
    tasks={"task0": {"id": 0, "name": "majority", "act_fn": "softmax",
                     "metric": "accuracy"},
           "task1": {"id": 1, "name": "multi", "act_fn": "sigmoid",
                     "metric": "multilabel_accuracy"}})
PROB_ATOL = 2.0 ** -7
# the reference's scores over all N = 23 candidates are softmax weights
# near 1/23 = 0.043; a bf16 flip (2^-8 relative) upstream moves one by
# about 2e-4, so a swap further than 5e-4 from the M-th kept score is no
# near-tie
SCORE_GAP = 5e-4
# relative Frobenius distance of a stage's output from the reference's
STAGE_RTOL = {"encoder": 1e-3, "aggregate": 2e-3}


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
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
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


def _reference_scores(jp, x):
    """The reference's saliency over all N candidates at once (eval-mode
    encoder, the kept set's tie rule aside): what a near-tie is measured
    in."""
    from ips_tpu.models.ips_net import IPSModel
    tr = jp.trainer
    variables = {"params": tr.state.params,
                 "batch_stats": tr.state.batch_stats}
    emb = tr.model.apply(variables, jnp.asarray(x), method=IPSModel.encode)
    scores = tr.model.apply(variables, emb, None, method=IPSModel.scores)
    return np.asarray(scores, np.float32)


def check_selection(jp, x, a_idx, b_idx, M):
    """Equal selections, or swaps only among near-tied candidates."""
    if np.array_equal(a_idx, b_idx):
        return
    scores = _reference_scores(jp, x)
    for r in range(a_idx.shape[0]):
        swapped = np.setxor1d(a_idx[r], b_idx[r])
        if swapped.size == 0:
            continue
        kth = np.sort(scores[r][a_idx[r]])[0]
        gap = np.abs(scores[r][swapped] - kth).max()
        print(f"row {r}: swapped candidates {swapped.tolist()}, largest "
              f"score gap to the M-th kept score {gap:.3e}")
        assert gap < SCORE_GAP, (r, swapped, gap)


@pytest.mark.parametrize("over", [{}, {"eval_reuse_emb": False},
                                  {"score_impl": "attn"}],
                         ids=["reuse_emb", "re_encode", "attn"])
def test_predictor_bf16_matches_jax(jax_trainer, over):
    jp, tp = _pair(jax_trainer, **over)
    for seed in (2, 3):
        x = _inputs(seed)
        a, b = jp.predict(x), tp.predict(x)
        check_selection(jp, x, a["selected_idx"], b["selected_idx"],
                        TINY["M"])
        for name in ("majority", "multi"):
            err = np.abs(b[name] - a[name]).max()
            print(f"seed {seed} {name}: max |p_port - p_jax| {err:.3e}")
            np.testing.assert_allclose(b[name], a[name], rtol=0,
                                       atol=PROB_ATOL)


def test_predictor_bf16_runs_in_bf16(jax_trainer):
    """The port really computes in bf16 here: its probabilities differ
    from the same weights in fp32 compute by more than fp32 noise."""
    _, tp = _pair(jax_trainer)
    tp32 = Predictor(t_config(dict(TINY, compute_dtype="float32",
                                   input_dtype="float32")),
                     trainer=tp.trainer, device="cpu")
    x = _inputs(2)
    diff = np.abs(tp.predict(x)["majority"] - tp32.predict(x)["majority"])
    assert diff.max() > 1e-5


def _set_stage_dtype(model, stage, dtype):
    """Set the compute dtype of one stage's modules in place: the
    encoder's convs, or the transformer's projections."""
    for mod in model.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype) and (
                isinstance(mod, Conv) == (stage == "encoder")):
            mod.dtype = dtype


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("stage", ["encoder", "aggregate"])
def test_stage_bf16_matches_jax(jax_trainer, stage):
    """Each stage in bf16 is within STAGE_RTOL of the reference's, and the
    same stage computed in fp32 is not: a missing cast fails this test."""
    from ips_tpu.models.ips_net import IPSModel
    _, tp = _pair(jax_trainer)
    model = tp.trainer.model
    variables = {"params": jax_trainer.state.params,
                 "batch_stats": jax_trainer.state.batch_stats}
    for seed in (2, 3):
        if stage == "encoder":
            x = _inputs(seed)
            want = jax_trainer.model.apply(
                variables, jnp.asarray(x, jnp.bfloat16),
                method=IPSModel.encode)
            arg, fn = torch.from_numpy(x).to(torch.bfloat16), model.encode
        else:
            emb = np.random.default_rng(seed).standard_normal(
                (2, TINY["M"], TINY["D"])).astype(np.float32)
            want = jax_trainer.model.apply(variables, jnp.asarray(emb),
                                           method=IPSModel.aggregate)
            arg, fn = torch.from_numpy(emb), model.aggregate
        want = np.asarray(want, np.float32)
        with torch.no_grad():
            got = fn(arg).float().numpy()
            _set_stage_dtype(model, stage, torch.float32)
            got32 = fn(arg).float().numpy()
            _set_stage_dtype(model, stage, torch.bfloat16)
        d16, d32 = _rel(got, want), _rel(got32, want)
        print(f"seed {seed} {stage}: relative distance bf16 {d16:.3e}, "
              f"fp32 {d32:.3e} (bound {STAGE_RTOL[stage]})")
        assert d16 < STAGE_RTOL[stage]
        assert d32 > STAGE_RTOL[stage]
