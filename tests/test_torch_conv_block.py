"""The port's layer1 conv probe and fused BasicBlock against the JAX probe.

scripts/probe_conv.py is loaded by file path, as the JAX package's own
code; it turns on the persistent compilation cache when imported, so the
fixture points that cache at a temporary directory and puts the settings
back afterwards. ``pallas_block`` runs in Pallas interpret mode on the CPU
by itself. Inputs come from a seeded numpy generator; weights come from
the JAX probe's ``make_block_params`` and reach the port through
``weights.block_params_from_reference``. The CUDA kernel is held against
``plain_fused_block`` on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.compilation_cache import compilation_cache

from ips_tpu_torch.ops import conv_block as cb
from ips_tpu_torch.scripts import probe_conv as tp
from ips_tpu_torch.weights import block_params_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = os.path.join(REPO, "scripts", "probe_conv.py")

# bf16 outputs: both sides sum the same exact products in fp32 in another
# order before rounding to bf16, so a rounding may move by one bf16 ulp,
# 1.6e-2 for |y| < 4.
TOL = 1.6e-2
# fp32 conv outputs (no bf16 rounding after the sum): a few fp32 ulps.
CONV_TOL = 1e-5


@pytest.fixture(scope="module")
def jp(tmp_path_factory):
    """The JAX probe module, with its compilation cache in a temp dir."""
    saved_env = os.environ.get("IPS_TPU_JAX_CACHE")
    saved_path = list(sys.path)
    saved_dir = jax.config.jax_compilation_cache_dir
    saved_min = jax.config.jax_persistent_cache_min_compile_time_secs
    os.environ["IPS_TPU_JAX_CACHE"] = str(tmp_path_factory.mktemp("jaxc"))
    try:
        spec = importlib.util.spec_from_file_location("jax_probe_conv",
                                                      PROBE)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod
    finally:
        sys.path[:] = saved_path
        if saved_env is None:
            os.environ.pop("IPS_TPU_JAX_CACHE", None)
        else:
            os.environ["IPS_TPU_JAX_CACHE"] = saved_env
        jax.config.update("jax_compilation_cache_dir", saved_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved_min)
        compilation_cache.reset_cache()


def _x(shape, seed=0):
    """Seeded activations, rounded to bf16 identically on both sides."""
    a = 0.5 * np.random.default_rng(seed).standard_normal(shape, np.float32)
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def _params(jp, c, seed):
    """JAX probe params and the port's copy of them."""
    p = jp.make_block_params(jax.random.PRNGKey(seed), c)
    return p, block_params_from_reference(
        {k: np.asarray(v) for k, v in p.items()})


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    err = float(np.max(np.abs(got - want)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                               err_msg=f"max abs err {err}")


def test_block_params_from_reference(jp):
    p, t = _params(jp, 8, 0)
    assert set(t) == set(p)
    for k in p:
        assert t[k].dtype == (torch.bfloat16 if k.startswith("w")
                              else torch.float32)
        np.testing.assert_array_equal(_np(t[k]), _np(p[k]))


def test_make_block_params():
    p = tp.make_block_params(torch.Generator().manual_seed(3), 16)
    assert p["w1"].shape == (3, 3, 16, 16) and p["w1"].dtype == torch.bfloat16
    assert p["s2"].shape == (16,) and p["s2"].dtype == torch.float32
    again = tp.make_block_params(torch.Generator().manual_seed(3), 16)
    assert all(torch.equal(p[k], again[k]) for k in p)
    np_seeded = tp.make_block_params(3, 16)
    assert torch.equal(np_seeded["b1"], tp.make_block_params(3, 16)["b1"])
    assert not torch.equal(p["s1"], p["s2"])


@pytest.mark.parametrize("s", [5, 7])
def test_pallas_block_vs_plain_fused_block(jp, s):
    """The TPU kernel (interpret mode) and the plain version of the port's
    kernel, on the paired layout: n2=4 pairs of c=8, tile 2."""
    c = 8
    jx, tx = _x((4, s, s, 2 * c), seed=s)
    p, t = _params(jp, c, s)
    want = jp.pallas_block(jx, jp.pair_params(p, c), 2)
    got = cb.plain_fused_block(tx, cb.kernel_params(tp.pair_params(t, c)))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _close(got, want)
    # the wrapper takes the plain version for a CPU tensor
    _close(cb.fused_block(tx, cb.kernel_params(tp.pair_params(t, c))), want)


def test_block_and_layer1_ref(jp):
    jx, tx = _x((6, 5, 5, 8), seed=1)
    (p0, t0), (p1, t1) = _params(jp, 8, 10), _params(jp, 8, 11)
    _close(tp.block_ref(tx, t0), jp.block_xla(jx, p0))
    _close(tp.layer1_ref(tx, t0, t1), jp.layer1_xla(jx, p0, p1))


def test_conv_ref_and_tap9(jp):
    jx, tx = _x((3, 6, 6, 8), seed=2)
    p, t = _params(jp, 8, 2)
    want = jp.conv_xla(jx, p["w1"])
    _close(tp.conv_ref(tx, t["w1"]), want, CONV_TOL)
    _close(tp.conv_tap9(tx, t["w1"]), jp.conv_tap9(jx, p["w1"]), CONV_TOL)
    _close(tp.conv_tap9(tx, t["w1"]), want, CONV_TOL)


def test_layer1_tap9_and_pair(jp):
    c = 8
    jx, tx = _x((4, 5, 5, c), seed=3)
    (p0, t0), (p1, t1) = _params(jp, c, 20), _params(jp, c, 21)
    _close(tp.layer1_tap9(tx, t0, t1), jp.layer1_tap9(jx, p0, p1))
    q0, q1 = tp.pair_params(t0, c), tp.pair_params(t1, c)
    _close(tp.layer1_tap9_pair(tx, q0, q1, c),
           jp.layer1_tap9_pair(jx, jp.pair_params(p0, c),
                               jp.pair_params(p1, c), c))


def test_pair_pack_unpack_params_exact(jp):
    c = 8
    jx, tx = _x((6, 5, 5, c), seed=4)
    packed = tp.pair_pack(tx)
    np.testing.assert_array_equal(_np(packed), _np(jp.pair_pack(jx)))
    np.testing.assert_array_equal(_np(tp.pair_unpack(packed, c)),
                                  _np(jp.pair_unpack(jp.pair_pack(jx), c)))
    assert torch.equal(tp.pair_unpack(packed, c), tx)
    p, t = _params(jp, c, 4)
    jq, tq = jp.pair_params(p, c), tp.pair_params(t, c)
    assert set(tq) == set(jq)
    for k in jq:
        np.testing.assert_array_equal(_np(tq[k]), _np(jq[k]))
        assert tq[k].dtype == t[k].dtype


def test_layer1_pallas_pair_vs_fused_pair(jp):
    c = 8
    jx, tx = _x((8, 5, 5, c), seed=5)
    (p0, t0), (p1, t1) = _params(jp, c, 30), _params(jp, c, 31)
    want = jp.layer1_pallas_pair(jx, jp.pair_params(p0, c),
                                 jp.pair_params(p1, c), c, 2)
    got = tp.layer1_fused_pair(tx, tp.pair_params(t0, c),
                               tp.pair_params(t1, c), c)
    _close(got, want)
    _close(tp.layer1_fused(tx, t0, t1), want)


def test_cudnn_variant_matches_ref(jp):
    """The library yardstick rounds each conv's output to bf16, once more
    than the reference: within the probe's 0.1 check, and near one ulp."""
    jx, tx = _x((4, 5, 5, 8), seed=6)
    (p0, t0), (p1, t1) = _params(jp, 8, 40), _params(jp, 8, 41)
    got = tp.layer1_cudnn(tx, tp.cudnn_params(t0), tp.cudnn_params(t1))
    _close(got, jp.layer1_xla(jx, p0, p1), 2 * TOL)


def test_probe_main_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    record = os.path.join(REPO, "results", "conv_probe.json")
    with open(record, "rb") as f:
        before = f.read()
    out = tp.main(["--device", "cpu", "--shape", "8,5,8"])
    assert out["shape"] == [8, 5, 5, 8]
    assert out["useful_flops"] == tp.layer1_flops(8, 5, 8)
    assert set(out["variants"]) == {"ref", "cudnn_conv", "tap9",
                                    "tap9_pair", "fused_pair", "fused"}
    for name, row in out["variants"].items():
        assert row["max_abs_err"] <= tp.MAX_ERR, name
        assert "ms" not in row and "tf_s" not in row   # no device time
    assert os.listdir(tmp_path) == []
    with open(record, "rb") as f:
        assert f.read() == before
    path = tmp_path / "probe.json"
    tp.main(["--device", "cpu", "--shape", "4,3,8", "--out", str(path)])
    assert json.loads(path.read_text())["shape"] == [4, 3, 3, 8]


def test_probe_main_rejects_odd_patch_count():
    with pytest.raises(ValueError, match="even"):
        tp.main(["--device", "cpu", "--shape", "3,5,8"])


def test_layer1_bound_matches_shapes():
    ms, by = tp.layer1_bound(1600, 13, 64)
    assert by == "operations" and abs(ms * 1e3 - 80.63) < 0.01
    ms, by = tp.layer1_bound(1600, 13, 64, paired=True)
    assert by == "operations" and abs(ms * 1e3 - 161.26) < 0.01
    assert tp.FLOPS == 79_744_204_800


def test_fused_block_rejects_bad_inputs():
    x = torch.zeros((2, 5, 5, 8), dtype=torch.bfloat16)
    q = cb.kernel_params(tp.make_block_params(0, 8))
    with pytest.raises(ValueError, match="bf16"):
        cb.fused_block(x.float(), q)
    with pytest.raises(ValueError, match="w2"):
        cb.fused_block(x, {**q, "w2": q["w2"][:8]})
    with pytest.raises(ValueError, match="s1"):
        cb.fused_block(x, {**q, "s1": q["s1"].double()})
    with pytest.raises(ValueError, match="device"):
        cb.fused_block(x.to("meta"), q)
