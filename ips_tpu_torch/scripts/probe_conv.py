"""Layer1 conv probe on the card (counterpart of scripts/probe_conv.py).

Times alternatives for ResNet layer1 (two eval-mode BasicBlocks with
folded BN and the residual) on its real shape in the IPS encoder: one
chunk of B*I = 1600 patches of 13x13x64 bf16 (50x50 patches -> stem
25x25 -> max-pool 13x13). Layout NHWC, weights HWIO, as in the JAX
probe.

  ref         conv in fp32 on the bf16 values widened (the JAX probe's
              ``preferred_element_type=f32``), bf16 where JAX rounds:
              the numerics reference every variant is held against
  cudnn_conv  ``F.conv2d`` in bf16 on a channels_last view, folded BN,
              ReLU and residual in PyTorch: what the encoder does (the
              library yardstick, never called by the kernel path)
  tap9        conv as nine shifted-slice products, fp32 accumulation
  tap9_pair   the same on the pair-packed layout (800, 13, 13, 128) with
              block-diagonal weights: 2x the FLOPs
  fused_pair  the hand-written fused BasicBlock kernel
              (``ops/conv_block.fused_block``) on the pair-packed layout,
              as the TPU kernel ran (its pallas_pair_t32/t64 variants; the
              VMEM tile has no counterpart here)
  fused       the same kernel at c=64 on the unpacked layout

Every variant is checked against ``ref`` (max abs error over 0.1 raises)
and timed: on the card, the profiler's summed kernel time per call and a
CUDA-event time of back-to-back calls. A CPU run checks the numerics and
measures no time. One JSON line goes to stdout; a file is written only at
``--out``.

    python -m ips_tpu_torch.scripts.probe_conv [--device cuda]
        [--shape P,S,C] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from ips_tpu_torch.ops.conv_block import (conv_taps, eval_block,
                                          fused_block, kernel_params)
from ips_tpu_torch.utils.device import fp32_matmuls, resolve_device
from ips_tpu_torch.utils.timing import bound_ms, cuda_ms, device_ms

BF16 = torch.bfloat16
P, S, C = 1600, 13, 64          # patches, spatial, channels (layer1 shape)
MAX_ERR = 0.1
ITERS, WARMUP = 10, 3           # timed calls per variant, after warm-up
SEED = 0

Params = Dict[str, torch.Tensor]


def layer1_flops(p: int, s: int, c: int) -> int:
    """Useful FLOPs of layer1: 2 blocks x 2 convs (residuals ~free)."""
    return 4 * p * s * s * (9 * c) * c * 2


FLOPS = layer1_flops(P, S, C)


# ---------------------------------------------------------------- weights
def make_block_params(rng: Union[torch.Generator, int], c: int,
                      device: Union[str, torch.device] = "cpu") -> Params:
    """Random BasicBlock parameters: w1, w2 (3, 3, c, c) bf16 HWIO; s1, b1,
    s2, b2 (c,) fp32, a folded eval BN's scale and shift. ``rng`` is a
    torch.Generator or a numpy seed. Each tensor is drawn on its own (the
    JAX probe draws s2 and b2 from the keys of s1 and b1)."""
    if isinstance(rng, torch.Generator):
        def normal(*shape):
            return torch.randn(shape, generator=rng)
    else:
        gen = np.random.default_rng(rng)

        def normal(*shape):
            return torch.from_numpy(gen.standard_normal(shape, np.float32))
    std = 0.05 / np.sqrt(c)
    p = {"w1": (normal(3, 3, c, c) * std).to(BF16),
         "w2": (normal(3, 3, c, c) * std).to(BF16),
         "s1": 1.0 + 0.1 * normal(c), "b1": 0.1 * normal(c),
         "s2": 1.0 + 0.1 * normal(c), "b2": 0.1 * normal(c)}
    return {k: v.to(device) for k, v in p.items()}


# ------------------------------------------------------------------ ref
def conv_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, s, s, c) x (3, 3, c, c) -> (n, s, s, c) fp32, conv in fp32 (on
    the card, with ``torch.backends.cudnn.allow_tf32`` off)."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def block_ref(x: torch.Tensor, p: Params) -> torch.Tensor:
    return eval_block(conv_ref, x, p)


def layer1_ref(x: torch.Tensor, p0: Params, p1: Params) -> torch.Tensor:
    return block_ref(block_ref(x, p0), p1)


# ----------------------------------------------------------- cudnn_conv
def cudnn_params(p: Params) -> Params:
    """Probe parameters with the weights as OIHW channels_last, the layout
    ``F.conv2d`` takes for a channels_last input (made once, untimed)."""
    q = dict(p)
    for k in ("w1", "w2"):
        q[k] = p[k].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
    return q


def conv_cudnn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 conv of NHWC x (a channels_last NCHW view) by OIHW w; NHWC
    bf16 out."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def block_cudnn(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Takes :func:`cudnn_params`; BN, ReLU and residual in fp32."""
    return eval_block(lambda a, w: conv_cudnn(a, w).float(), x, p)


def layer1_cudnn(x: torch.Tensor, p0: Params, p1: Params) -> torch.Tensor:
    return block_cudnn(block_cudnn(x, p0), p1)


# ---------------------------------------------------------------- tap9
def conv_tap9(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv as 9 accumulated products on shifted slices, fp32."""
    return conv_taps(x, w.reshape(9, w.shape[2], w.shape[3]))


def block_tap9(x: torch.Tensor, p: Params) -> torch.Tensor:
    return eval_block(conv_tap9, x, p)


def layer1_tap9(x: torch.Tensor, p0: Params, p1: Params) -> torch.Tensor:
    return block_tap9(block_tap9(x, p0), p1)


# ----------------------------------------------------------- paired layout
def pair_pack(x: torch.Tensor) -> torch.Tensor:
    """(P, s, s, c) -> (P/2, s, s, 2c): two patches share the channel dim."""
    n, s, _, c = x.shape
    return (x.reshape(n // 2, 2, s, s, c).permute(0, 2, 3, 1, 4)
            .reshape(n // 2, s, s, 2 * c))


def pair_unpack(y: torch.Tensor, c: int) -> torch.Tensor:
    n2, s, _, _ = y.shape
    return (y.reshape(n2, s, s, 2, c).permute(0, 3, 1, 2, 4)
            .reshape(n2 * 2, s, s, c))


def pair_params(p: Params, c: int) -> Params:
    """Block-diagonal weights, BN terms tiled over the paired channels."""
    def bd(w):
        out = w.new_zeros((3, 3, 2 * c, 2 * c))
        out[:, :, :c, :c] = w
        out[:, :, c:, c:] = w
        return out
    q = {k: bd(p[k]) for k in ("w1", "w2")}
    q.update({k: p[k].repeat(2) for k in ("s1", "b1", "s2", "b2")})
    return q


def layer1_tap9_pair(x: torch.Tensor, q0: Params, q1: Params,
                     c: int) -> torch.Tensor:
    y = block_tap9(block_tap9(pair_pack(x), q0), q1)
    return pair_unpack(y, c)


# -------------------------------------------------------------- fused
def layer1_fused_pair(x: torch.Tensor, q0: Params, q1: Params,
                      c: int) -> torch.Tensor:
    """The fused kernel at 2c on the paired layout (counterpart of
    ``layer1_pallas_pair``); q0, q1 from :func:`pair_params`."""
    y = fused_block(fused_block(pair_pack(x), kernel_params(q0)),
                    kernel_params(q1))
    return pair_unpack(y, c)


def layer1_fused(x: torch.Tensor, p0: Params, p1: Params) -> torch.Tensor:
    """The fused kernel at c on the unpacked layout."""
    return fused_block(fused_block(x, kernel_params(p0)), kernel_params(p1))


# ------------------------------------------------------------------ main
def layer1_bound(p: int, s: int, c: int, paired: bool = False):
    """(ms, "bytes" | "operations"): least time for layer1 on the card.
    Bytes: x in and y out once (bf16), four convs' weights and BN terms;
    operations: the FLOPs executed, twice the useful ones when paired."""
    cw = 2 * c if paired else c
    n = p // 2 if paired else p
    nbytes = 2 * (2 * p * s * s * c) + 4 * (9 * cw * cw * 2 + 2 * cw * 4)
    return bound_ms(nbytes, layer1_flops(n, s, cw), "bfloat16")


def _parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m ips_tpu_torch.scripts.probe_conv",
        description="Time layer1 conv alternatives at the IPS encoder's "
                    "layer1 chunk shape.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu on request)")
    ap.add_argument("--shape", default=f"{P},{S},{C}",
                    help="P,S,C: patches (even), spatial side, channels")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    # stated numerics: fp32 convs and products in full fp32
    fp32_matmuls()
    args = _parse(argv)
    device = resolve_device(args.device)
    p, s, c = (int(v) for v in args.shape.split(","))
    if p % 2:
        raise ValueError(f"--shape: P={p} must be even to pair patches")
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    print(f"probing on {name}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((p, s, s, c), np.float32)
                         * 0.5).to(device, BF16)
    gen = torch.Generator().manual_seed(SEED)
    p0 = make_block_params(gen, c, device)
    p1 = make_block_params(gen, c, device)
    q0, q1 = pair_params(p0, c), pair_params(p1, c)
    c0, c1 = cudnn_params(p0), cudnn_params(p1)
    want = layer1_ref(x, p0, p1).float()

    variants = {
        "ref": ("xla_conv", lambda: layer1_ref(x, p0, p1)),
        "cudnn_conv": ("xla_conv", lambda: layer1_cudnn(x, c0, c1)),
        "tap9": ("tap9", lambda: layer1_tap9(x, p0, p1)),
        "tap9_pair": ("tap9_pair", lambda: layer1_tap9_pair(x, q0, q1, c)),
        "fused_pair": ("pallas_pair_t32, pallas_pair_t64",
                       lambda: layer1_fused_pair(x, q0, q1, c)),
        "fused": ("pallas_pair_t32, pallas_pair_t64 (unpaired)",
                  lambda: layer1_fused(x, p0, p1)),
    }
    flops = layer1_flops(p, s, c)
    rows = {}
    for vname, (replaces, fn) in variants.items():
        got = fn()
        err = float((got.float() - want).abs().max())
        if not err <= MAX_ERR:
            raise AssertionError(f"{vname}: max abs err {err:.4f} against "
                                 f"ref exceeds {MAX_ERR}")
        row = {"replaces": replaces, "max_abs_err": err}
        if on_card:
            ms = device_ms(fn, iters=ITERS, warmup=WARMUP)
            ev = cuda_ms(fn, iters=ITERS, warmup=WARMUP)
            row.update(ms=ms, event_ms=ev,
                       tf_s=None if ms is None else flops / ms / 1e9)
            print(f"{vname:12s} device {ms} ms, events {ev:.3f} ms, "
                  f"err {err:.2e}", file=sys.stderr, flush=True)
        rows[vname] = row

    bound, bound_by = layer1_bound(p, s, c)
    pbound, pbound_by = layer1_bound(p, s, c, paired=True)
    out = {"device": name, "shape": [p, s, s, c], "useful_flops": flops,
           "bound_ms": bound, "bound_by": bound_by,
           "paired_bound_ms": pbound, "paired_bound_by": pbound_by,
           "timer": ("ms: torch.profiler summed kernel time per call; "
                     "event_ms: CUDA events over back-to-back calls"
                     if on_card else "none: a CPU run checks numerics only"),
           "variants": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
