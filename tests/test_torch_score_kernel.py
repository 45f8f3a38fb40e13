"""The port's saliency scorer against the JAX package's.

Inputs come from a seeded numpy generator and go to both sides. The JAX
Pallas kernel runs in interpret mode, as tests/test_score_kernel.py runs
it on the CPU; the port's kernel wrapper takes its plain version on a CPU
tensor. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_gpu.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ips_tpu.models.transformer import CrossAttnTransformer
from ips_tpu.ops import score_kernel as jsk
from ips_tpu_torch.ops import score_kernel as tsk

B, L, D, H, DK, T = 2, 40, 32, 4, 8, 3


@pytest.fixture(scope="module")
def folded():
    """JAX transformer params, numpy embeddings, and both W_eff."""
    m = CrossAttnTransformer(n_token=T, H=H, D=D, D_k=DK, D_v=DK,
                             D_inner=64)
    x = np.random.default_rng(0).standard_normal((B, L, D), np.float32)
    variables = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    att = variables["params"]["crs_attn"]
    j_w = jsk.fold_query(att["q"], att["q_w"]["kernel"],
                         att["k_w"]["kernel"], H, DK)
    q, wq, wk = (torch.from_numpy(np.array(a)) for a in (
        att["q"], att["q_w"]["kernel"], att["k_w"]["kernel"]))
    t_w = tsk.fold_query(q, wq, wk, H, DK)
    return m, variables, x, np.asarray(j_w), t_w


def _masks():
    mask = np.ones((B, L), bool)
    mask[0, -5:] = False
    mask[1, :3] = False
    full = mask.copy()
    full[1] = False                     # one fully masked row
    return [None, mask, full]


def test_fold_query_matches(folded):
    _, _, _, j_w, t_w = folded
    np.testing.assert_allclose(t_w.numpy(), j_w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask_i", range(3))
def test_fast_scores_match_jax(folded, mask_i):
    _, _, x, j_w, t_w = folded
    mask = _masks()[mask_i]
    ref = np.asarray(jsk.fast_scores(
        jnp.asarray(x), jnp.asarray(j_w),
        None if mask is None else jnp.asarray(mask)))
    tm = None if mask is None else torch.from_numpy(mask)
    got = tsk.fast_scores(torch.from_numpy(x), t_w, tm).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    kern = tsk.scores(torch.from_numpy(x), t_w, tm).numpy()
    np.testing.assert_allclose(kern, ref, rtol=1e-5, atol=1e-6)


# Pallas' epilogue adds NEG_INF as a bias, so a fully masked row there
# keeps the unmasked softmax (softmax is shift-invariant); fast_scores and
# the port replace the logits and give a uniform row, checked above.
@pytest.mark.parametrize("mask_i", range(2))
def test_scores_match_pallas_interpret(folded, mask_i):
    _, _, x, j_w, t_w = folded
    mask = _masks()[mask_i]
    ref = np.asarray(jsk.pallas_scores(
        jnp.asarray(x), jnp.asarray(j_w),
        None if mask is None else jnp.asarray(mask), interpret=True))
    tm = None if mask is None else torch.from_numpy(mask)
    got = tsk.scores(torch.from_numpy(x), t_w, tm).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_fully_masked_row_is_uniform(folded):
    _, _, x, _, t_w = folded
    mask = torch.from_numpy(_masks()[2])
    got = tsk.scores(torch.from_numpy(x), t_w, mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[1], torch.full((L,), 1.0 / L),
                               rtol=1e-6, atol=0.0)


def test_scores_match_attention_path(folded):
    m, variables, x, _, t_w = folded
    ref = np.asarray(m.apply(variables, jnp.asarray(x),
                             method=CrossAttnTransformer.get_scores))
    got = tsk.scores(torch.from_numpy(x), t_w).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 10000, 512, 8), (2, 37, 16, 12),
                                   (4, 1037, 128, 32)],
                         ids=["tiled_camelyon", "unaligned", "ragged"])
def test_tiled_and_unaligned_match_pallas(shape):
    b, l, d, th = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, l, d), np.float32)
    w = 0.1 * rng.standard_normal((d, th), np.float32)
    ref = np.asarray(jsk.pallas_scores(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = tsk.scores(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)


def test_logits_plain_on_cpu_counts_nothing():
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    before = tsk.logits.launches
    out = tsk.logits(x, w)
    assert out.dtype == torch.float32 and out.shape == (2, 5, 4)
    torch.testing.assert_close(out, x @ w)
    assert tsk.logits.launches == before


def test_logits_rejects_other_devices():
    x = torch.empty(2, 5, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsk.logits(x, torch.empty(8, 4, device="meta"))


def test_kernel_times_needs_a_card(monkeypatch, capsys):
    """The timing script measures device times only: without a card it
    refuses (exit code 1) and prints no measurement."""
    from ips_tpu_torch.scripts import kernel_times
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_times.main() == 1
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("case,want_us,by", [
    (("score_logits", 16, 200, 128, 32, "float32"), 0.616, "bytes"),
    (("score_logits", 1, 10000, 512, 8, "bfloat16"), 3.155, "bytes"),
    (("score_logits", 16, 42, 512, 8, "float32"), 0.422, "bytes"),
    (("conv_block", 1600, 13, 64), 40.32, "operations"),
    (("conv_block", 1600, 7, 128), 46.76, "operations")],
    ids=["logits_mnist", "logits_camelyon", "logits_traffic",
         "block_layer1", "block_layer2"])
def test_kernel_bounds(case, want_us, by):
    """The least times the timing script and chip_smoke.py report, at the
    paths' shapes: H100 data-sheet rates (3.35 TB/s, 67 TFLOP/s fp32, 989
    TFLOP/s bf16)."""
    from ips_tpu_torch.scripts import kernel_times
    fn = (kernel_times.logits_bound if case[0] == "score_logits"
          else kernel_times.block_bound)
    ms, got_by = fn(*case[1:])
    assert got_by == by
    assert ms * 1e3 == pytest.approx(want_us, abs=5e-3)


def test_device_ms_refuses_partial_profiles(monkeypatch):
    """A profile in which a kernel ran a number of times that is not a
    multiple of the calls (a record lost, or another call's caught) is
    taken again and reported; only a whole one gives the time."""
    from ips_tpu_torch.utils import timing
    profiles = iter([{"k": (90.0, 9), "g": (50.0, 10)},
                     {"k": (110.0, 11), "g": (50.0, 10)},
                     {"k": (100.0, 10), "g": (40.0, 20)}])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "device_kernels",
                        lambda fn, iters: next(profiles))
    rejected = []
    ms = timing.device_ms(lambda: None, iters=10, warmup=0,
                          rejected=rejected)
    assert ms == pytest.approx(0.014)
    assert rejected == [{"k": 9, "g": 10}, {"k": 11, "g": 10}]
    profiles = iter([{"k": (90.0, 9)}] * timing.PROFILE_TRIES + [{}] *
                    timing.PROFILE_TRIES)
    assert timing.device_ms(lambda: None, iters=10, warmup=0) is None
    assert timing.device_ms(lambda: None, iters=10, warmup=0) is None
