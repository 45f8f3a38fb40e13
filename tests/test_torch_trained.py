"""The port on trained weights: ips_tpu's 150-epoch megapixel-MNIST
checkpoint (ckpt_mnist150/150), restored by ips_tpu, bridged into the
port with weights.load_jax (or read from its committed flat copy,
ips_tpu_torch/results/trained/mnist150_e150.npz, through the
Predictor's checkpoint argument), and both Predictors run at
config/mnist_config.yml as shipped (N=900 patches of 50x50, M=I=100,
bf16 compute and input, and again in fp32) on two generated test
images.

The selected indices must be the same set in each row, in the same
order in fp32. In bf16 their order may differ: about 795 of an image's 900 patches are blank, blank patches tie
exactly inside each implementation, and M=100 keeps some of them, so
where a kept non-blank patch's score lies within a bf16 flip of the
blank score the two implementations interleave them differently. The
aggregator (cross-attention pooling over the kept set, positions added
per patch) does not see that order. Probabilities agree within
PROB_ATOL = 2^-7: the bf16 argument of tests/test_torch_bf16.py, two
bf16 ulps of a probability near 1.
"""

import os
import shutil

import jax
import numpy as np
import pytest

from ips_tpu.config import load_config as j_load_config
from ips_tpu.data.mnist import MegapixelMNIST, generate_megapixel_mnist
from ips_tpu.infer import Predictor as JPredictor
from ips_tpu.train.steps import IPSTrainer as JTrainer
from ips_tpu.utils.checkpoint import CheckpointManager
from ips_tpu_torch import weights
from ips_tpu_torch.config import load_config as t_load_config
from ips_tpu_torch.infer import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "mnist_config.yml")
CHECKPOINT = os.path.join(ROOT, "ckpt_mnist150", "150")
NPZ = os.path.join(ROOT, "ips_tpu_torch", "results", "trained",
                   "mnist150_e150.npz")
PROB_ATOL = 2.0 ** -7


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(JAX config, trainer restored at epoch 150, the two test images'
    patches (2, 900, 50, 50, 1) and labels)."""
    tmp = tmp_path_factory.mktemp("trained")
    data_dir = str(tmp / "mnist")
    generate_megapixel_mnist(data_dir, n_train=1, n_test=2, seed=0,
                             digit_source="sklearn")
    over = [f"data_dir={data_dir}", "sparse_input=false"]
    conf = j_load_config(CONFIG, over)
    # restore from a copy: orbax may write beside the checkpoint it reads
    ckpt = tmp / "ckpt"
    shutil.copytree(CHECKPOINT, ckpt / "150")
    trainer = JTrainer(conf, rng=jax.random.PRNGKey(0))
    assert CheckpointManager(str(ckpt)).restore(trainer) == 150
    ds = MegapixelMNIST(conf, train=False)
    samples = [ds[i] for i in range(len(ds))]
    patches = np.stack([s["input"] for s in samples]).astype(np.float32)
    labels = {t.name: np.stack([s[t.name] for s in samples])
              for t in conf.task_list}
    return conf, trainer, patches, labels, over


# as shipped (bf16), and in fp32 compute, where the two differ only by
# the order of fp32 sums: tests/test_torch_infer.py's fp32 tolerance; the
# port's weights bridged from the restored trees (load_jax) or read from
# the committed flat copy of the same checkpoint (npz,
# ips_tpu_torch/results/trained/mnist150_e150.npz, the card's only copy)
@pytest.mark.parametrize("source,dtype,atol", [
    pytest.param("load_jax", "bfloat16", PROB_ATOL, id="bfloat16-0.0078125"),
    pytest.param("load_jax", "float32", 1e-5, id="float32-1e-05"),
    pytest.param("npz", "bfloat16", PROB_ATOL, id="npz-bfloat16-0.0078125"),
    pytest.param("npz", "float32", 1e-5, id="npz-float32-1e-05")])
def test_trained_weights_match_jax(trained, source, dtype, atol):
    conf, trainer, patches, labels, over = trained
    assert patches.shape == (2, conf.N, 50, 50, 1)
    over = over + [f"compute_dtype={dtype}", f"input_dtype={dtype}"]
    jp = JPredictor(j_load_config(CONFIG, over), trainer=trainer)
    tp = Predictor(t_load_config(CONFIG, over), device="cpu",
                   checkpoint=NPZ if source == "npz" else None)
    if source == "load_jax":
        weights.load_jax(tp.trainer.model, trainer.state.params,
                         trainer.state.batch_stats)
    a, b = jp.predict(patches), tp.predict(patches)
    np.testing.assert_array_equal(np.sort(b["selected_idx"], 1),
                                  np.sort(a["selected_idx"], 1))
    if dtype == "float32":          # no bf16 flips: the same order too
        np.testing.assert_array_equal(b["selected_idx"], a["selected_idx"])
    moved = int((b["selected_idx"] != a["selected_idx"]).sum())
    print(f"kept sets equal; {moved} of {a['selected_idx'].size} places "
          "hold another index of the same set")
    for task in conf.task_list:
        err = np.abs(b[task.name] - a[task.name]).max()
        print(f"{task.name}: max |p_port - p_jax| {err:.3e}")
        np.testing.assert_allclose(b[task.name], a[task.name], rtol=0,
                                   atol=atol)
    # the weights are trained: the majority task is right on these images
    np.testing.assert_array_equal(b["majority"].argmax(-1),
                                  labels["majority"])
