"""The port's initial draw follows the JAX package's distributions at the
shipped MNIST width: for seeds 0 and 1, ``IPSTrainer``'s draw (from
``torch.Generator().manual_seed(seed)``) against ``init_ips_model`` with
``PRNGKey(seed)``, tensor by tensor.

- Every random tensor passes a two-sample Kolmogorov-Smirnov test
  against JAX's at a family-wise level of ``ALPHA`` over all the tests of
  both seeds (Bonferroni: each p-value at least ``ALPHA`` / their count).
- Its standard deviation is within ``STD_RTOL`` of JAX's. A tensor of
  fewer than ``STD_MIN_SIZE`` values (the four heads' biases of 10, the
  MLP's biases of 128 and 512, the query tokens' 512) cannot be held
  there by itself: the sample std of 10 uniform values varies by ~20%
  between two draws of one distribution. Those are held together: each
  divided by its initializer's bound (U(-b, b) -> U(-1, 1)), the pooled
  values' std within ``STD_RTOL`` of JAX's pooled.
- No two random tensors of the port's draw share their leading values
  (a generator reseeded or reused per tensor would repeat them), and none
  equals JAX's.
- Norm scales, biases and running statistics start at JAX's constants,
  bitwise.
"""

import itertools
import math

import numpy as np
import pytest
import scipy.stats

from ips_tpu.config import config_from_dict as j_config
from ips_tpu_torch import weights
from ips_tpu_torch.config import config_from_dict as t_config
from ips_tpu_torch.train.steps import IPSTrainer

from test_torch_mnist_shipped import chip_smoke

SEEDS = (0, 1)
ALPHA = 0.01
STD_RTOL = 0.05
STD_MIN_SIZE = 1000
# random tensors of the shipped MNIST model: 10 convs, 4 heads' kernel and
# bias, 4 attention kernels, the query tokens, the MLP's 2 kernels and
# 2 biases
N_RANDOM = 27


@pytest.fixture(scope="module")
def draws():
    """{seed: (port flat, JAX flat)}."""
    import jax
    from ips_tpu.models.ips_net import init_ips_model
    out = {}
    for s in SEEDS:
        c = dict(chip_smoke.MNIST_CONFIG, seed=s)
        _, params, batch_stats = init_ips_model(j_config(c),
                                                jax.random.PRNGKey(s))
        jax_flat = weights.flatten_variables(params, batch_stats)
        port = IPSTrainer(t_config(c), device="cpu", init_opt=False)
        out[s] = weights.to_flat(port.model), jax_flat
    return out


def _random_keys(jax_flat):
    return sorted(k for k, v in jax_flat.items() if np.ptp(v) > 0)


def _bound(key, jax_flat):
    """The U(-b, b) bound of a small tensor's initializer: 1/sqrt(fan_in)
    of its layer's kernel; sqrt(1/D_k) for the query tokens."""
    if key.endswith("/q"):
        return math.sqrt(1.0 / chip_smoke.MNIST_CONFIG["D_k"])
    kernel = jax_flat[key.rsplit("/", 1)[0] + "/kernel"]
    return 1.0 / math.sqrt(kernel.shape[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_same_tensors_and_constants(draws, seed):
    port, jax_flat = draws[seed]
    assert port.keys() == jax_flat.keys()
    assert len(_random_keys(jax_flat)) == N_RANDOM
    for k, want in jax_flat.items():
        got = port[k]
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if np.ptp(want) == 0:
            assert got.tobytes() == want.tobytes(), k
            leaf = k.rsplit("/", 1)[1]
            assert want.flat[0] == {"scale": 1.0, "var": 1.0}.get(leaf, 0.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_each_random_tensor_passes_ks(draws, seed):
    port, jax_flat = draws[seed]
    level = ALPHA / (len(SEEDS) * N_RANDOM)
    for k in _random_keys(jax_flat):
        p = scipy.stats.ks_2samp(port[k].ravel(), jax_flat[k].ravel()).pvalue
        assert p >= level, f"{k}: KS p = {p:.3g} < {level:.3g}"


@pytest.mark.parametrize("seed", SEEDS)
def test_std_within_five_percent(draws, seed):
    port, jax_flat = draws[seed]
    small_port, small_jax = [], []
    for k in _random_keys(jax_flat):
        if jax_flat[k].size >= STD_MIN_SIZE:
            ratio = port[k].std() / jax_flat[k].std()
            assert abs(ratio - 1) <= STD_RTOL, f"{k}: std ratio {ratio:.4f}"
        else:
            b = _bound(k, jax_flat)
            small_port.append(port[k].ravel() / b)
            small_jax.append(jax_flat[k].ravel() / b)
    assert len(small_port) == 7
    ratio = np.concatenate(small_port).std() / np.concatenate(small_jax).std()
    assert abs(ratio - 1) <= STD_RTOL, f"small tensors: std ratio {ratio:.4f}"
    for x in (small_port, small_jax):    # U(-1, 1) after the scaling
        assert np.abs(np.concatenate(x)).max() <= 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_no_tensor_repeats(draws, seed):
    port, jax_flat = draws[seed]
    keys = _random_keys(jax_flat)
    for a, b in itertools.combinations(keys, 2):
        n = min(port[a].size, port[b].size)
        assert not np.array_equal(port[a].ravel()[:n], port[b].ravel()[:n]), \
            (a, b)
    for k in keys:
        assert not np.array_equal(port[k], jax_flat[k]), k
