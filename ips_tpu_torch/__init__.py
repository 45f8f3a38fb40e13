"""ips_tpu_torch — the PyTorch/CUDA port of ips_tpu (Iterative Patch
Selection), written for an NVIDIA H100.

``ips_tpu`` (JAX) stays the reference; each module here mirrors the
module of the same name there. Ported so far: inference
(:class:`ips_tpu_torch.infer.Predictor`), with the saliency scorer's
logits GEMM as a hand-written CUDA kernel (``csrc/score_logits.cu``), and
the layer1 conv probe (``ips_tpu_torch.scripts.probe_conv``, counterpart
of ``scripts/probe_conv.py``) with its fused BasicBlock kernel
(``csrc/conv_block.cu``); training (``train.steps.IPSTrainer``) and its
driver for megapixel MNIST (``python -m ips_tpu_torch.main``: data
generator and loader, epoch loops, sparse densify on the device,
metrics, checkpoints); the camelyon feature and end-to-end paths with
streaming selection; the slide-preprocessing pipeline
(``ips_tpu_torch.data.camelyon``: synth, otsu, foreground, extract_feat)
and pretrained encoder weights (``ips_tpu_torch.models.pretrained``); the
traffic-sign path; the host-side patch ops in C++ (``native``,
``csrc/hostops.cpp``, built with g++ at first use); int8 selection
(``select_dtype: int8``, ``models.quant``); and ``torch.export`` of the
Predictor (``python -m ips_tpu_torch.export``).
Entry points run on ``cuda`` unless the caller passes ``device='cpu'``.
"""

from ips_tpu_torch.config import Config, TaskConfig, load_config  # noqa: F401

__version__ = "0.1.0"
