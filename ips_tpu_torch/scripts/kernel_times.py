"""Device times of the port's two CUDA kernels at the shapes of their paths.

    python -m ips_tpu_torch.scripts.kernel_times

Prints one JSON line per (kernel, shape) with the profiler's device time
(``ms``, ``plain_ms``, ``library_ms``; None where every profile was
refused) of the kernel, of its plain version and of the library's
version (``torch.matmul`` for the logits; for the fused block its two
convolutions by cuDNN, the scale, bias, residual and ReLU in PyTorch),
the CUDA-event time per call of a back-to-back loop of each
(``event_ms``, ``event_plain_ms``, ``event_library_ms``), the profiles
``device_ms`` refused (kernel counts that are not a multiple of the
calls), the least time the card could take, and the card's SM clock,
memory clock, power draw and temperature as ``nvidia-smi`` reads them
just after the case; then the card's name and power limit.
``chip_smoke.py`` runs it in a process of its own for the times of its
``kernels`` line. It imports ``ips_tpu_torch`` from
``sys.path``, so the same script times another checkout of the package
when that checkout comes first on ``PYTHONPATH``: that is how two versions
of a kernel are compared in one run on one card.

The shapes and the bounds are defined here once; ``chip_smoke.py`` holds
each kernel against its plain version at the same shapes.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

# (name, B, L, D, TH, dtype): the MNIST selection shape (the main path
# scores (16, M+I=200, 128) against T*H = 4*8 = 32) in both types, the
# camelyon feature-mode shape (one slide, L = M+I = 10000, T*H = 8) and the
# camelyon_e2e one (one slide, L = M+I = 512 streamed tiles, T*H = 8), each
# in fp32 as its path runs it (the scorer takes fp32 embeddings) and bf16;
# the traffic one (B = 16, L = M+I = 42, D = 512, T*H = 1*8) in fp32, the
# type its path passes
LOGITS_CASES = (("mnist", 16, 200, 128, 32, "float32"),
                ("mnist", 16, 200, 128, 32, "bfloat16"),
                ("camelyon", 1, 10000, 512, 8, "float32"),
                ("camelyon", 1, 10000, 512, 8, "bfloat16"),
                ("camelyon_e2e", 1, 512, 512, 8, "float32"),
                ("camelyon_e2e", 1, 512, 512, 8, "bfloat16"),
                ("traffic", 16, 42, 512, 8, "float32"))
# (name, n, s, c, paired): layer1's chunk of 1600 patches of 13x13x64, the
# TPU kernel's pair-packed layout (block-diagonal weights), and
# layer2_block1's chunk (where c=128 would run on the main path)
BLOCK_CASES = (("layer1", 1600, 13, 64, False),
               ("layer1 paired", 800, 13, 128, True),
               ("layer2_block1", 1600, 7, 128, False))
ITERS = 50


def logits_bound(B, L, D, TH, dtype_name):
    """Least time on the card in ms, and what sets it: bytes (x and W_eff
    read once, fp32 logits written once) over the HBM rate, or FLOPs over
    the peak rate of x's type."""
    from ips_tpu_torch.utils.timing import bound_ms
    item = 4 if dtype_name == "float32" else 2
    nbytes = B * L * D * item + D * TH * item + B * L * TH * 4
    return bound_ms(nbytes, 2 * B * L * D * TH, dtype_name)


def block_bound(n, s, c):
    """The same for one fused BasicBlock on (n, s, s, c) bf16: x read and
    the output written once, both convs' bf16 weights and four fp32
    scale/bias vectors read once; two 3x3 convs of FLOPs."""
    from ips_tpu_torch.utils.timing import bound_ms
    nbytes = 2 * (2 * n * s * s * c) + 2 * (9 * c * c * 2) + 4 * c * 4
    return bound_ms(nbytes, 2 * n * s * s * 9 * c * c * 2, "bfloat16")


def _smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _card_state():
    return _smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")


def main() -> int:
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from ips_tpu_torch.ops import conv_block as cb
    from ips_tpu_torch.ops import score_kernel as sk
    from ips_tpu_torch.scripts import probe_conv as pc
    from ips_tpu_torch.utils.timing import cuda_ms, device_ms
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def times(iters, warmup=20, **fns):
        """For each of ``fns`` (ms: the kernel, plain_ms: its plain
        version, library_ms: the library's): the profiler's device time,
        and under ``event_`` + its key the CUDA-event time per call of a
        back-to-back loop; the profiles device_ms refused."""
        refused, out = [], {}
        for k, fn in fns.items():
            out[k] = device_ms(fn, iters, warmup, rejected=refused)
            out["event_" + k] = cuda_ms(fn, iters, warmup)
        return dict(out, refused_profiles=refused)

    for name, B, L, D, TH, dt in LOGITS_CASES:
        x = torch.from_numpy(rng.standard_normal((B, L, D), np.float32)
                             ).to(dev, dtypes[dt])
        w = torch.from_numpy(0.1 * rng.standard_normal((D, TH), np.float32)
                             ).to(dev, dtypes[dt])
        bound = logits_bound(B, L, D, TH, dt)
        print(json.dumps({
            "kernel": "score_logits", "shape": [B, L, D, TH], "dtype": dt,
            "case": name,
            **times(ITERS, ms=lambda: sk.logits(x, w),
                    plain_ms=lambda: sk.plain_logits(x, w),
                    library_ms=lambda: torch.matmul(x, w)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "card_state": _card_state()}), flush=True)
    for name, n, s, c, paired in BLOCK_CASES:
        x = torch.from_numpy(0.5 * rng.standard_normal((n, s, s, c),
                                                        np.float32))
        x = x.to(dev, torch.bfloat16)
        p = pc.make_block_params(2, c // 2 if paired else c, dev)
        if paired:
            p = pc.pair_params(p, c // 2)
        q, cp = cb.kernel_params(p), pc.cudnn_params(p)
        bound = block_bound(n, s, c)
        print(json.dumps({
            "kernel": "conv_block", "shape": [n, s, s, c], "case": name,
            "dtype": "bfloat16",
            **times(ITERS // 2, warmup=5,
                    ms=lambda: cb.fused_block(x, q),
                    plain_ms=lambda: cb.plain_fused_block(x, q),
                    library_ms=lambda: pc.block_cudnn(x, cp)),
            "bound_ms": bound[0], "bound_by": bound[1],
            "card_state": _card_state()}), flush=True)
    print(f"card: {_smi('name,power.limit')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
