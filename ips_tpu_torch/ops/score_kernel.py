"""Saliency scorer: one GEMM + masked softmax + head/token mean
(counterpart of ips_tpu/ops/score_kernel.py).

The learned query tokens are constants at scoring time, so the query
projection folds into the key projection:

    W_eff[d, (t, h)] = sum_k Wk[d, (h, k)] * (q @ Wq)[t, h, k] / sqrt(D_k)
    logits[b, l, (t, h)] = x[b, l] . W_eff[:, (t, h)]

and the scorer is one (L, D) x (D, T*H) product per batch row. On a CUDA
tensor :func:`logits` launches the hand-written kernel
``csrc/score_logits.cu`` (the port of the TPU kernel ``_logits_kernel``);
on a CPU tensor it runs :func:`plain_logits`, the same function in plain
PyTorch. Both go through the operator ``ips_tpu_torch::score_logits``,
which importing this module registers and which a program exported by
``ips_tpu_torch/export.py`` calls. :func:`scores` adds the epilogue (mask,
softmax over L, mean over T*H) in PyTorch, as the reference leaves it to
XLA after its kernel. :func:`fast_scores` is the plain version of the
whole scorer.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ips_tpu_torch.constants import NEG_INF
from ips_tpu_torch.utils.cuda_build import load_library

_KERNEL = "score_logits"


def fold_query(q: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, H: int,
               D_k: int) -> torch.Tensor:
    """Fold learned query tokens into the key projection.

    q: (1, T, D) raw query tokens; wq, wk: (D, H*D_k) projection kernels
    (the reference's (in, out) layout). Returns W_eff (D, T*H) fp32,
    already scaled by 1/sqrt(D_k).
    """
    T, D = q.shape[1], q.shape[2]
    qp = (q[0].float() @ wq.float()).reshape(T, H, D_k)
    wk_h = wk.float().reshape(D, H, D_k)
    w_eff = torch.einsum("dhk,thk->dth", wk_h, qp)
    return (w_eff / math.sqrt(D_k)).reshape(D, T * H)


def plain_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: (B, L, D) x (D, TH) -> (B, L, TH) fp32
    with fp32 accumulation."""
    return torch.einsum("bld,dc->blc", x.float(), w.float())


def _epilogue(lg: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, L, TH) logits -> (B, L): masked softmax over L, mean over TH."""
    if mask is not None:
        lg = lg.masked_fill(~mask[:, :, None], NEG_INF)
    return torch.softmax(lg, dim=1).mean(dim=-1)


def fast_scores(x: torch.Tensor, w_eff: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain scorer: (B, L, D), (D, TH) -> (B, L) mean softmax attention."""
    return _epilogue(plain_logits(x, w_eff), mask)


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.score_logits.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.score_logits.restype = i
    lib.score_logits_error_string.argtypes = [i]
    lib.score_logits_error_string.restype = ctypes.c_char_p
    lib.score_logits_max_th.argtypes = []
    lib.score_logits_max_th.restype = i
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Check x and w and launch ``csrc/score_logits.cu`` on them (counted
    in ``logits.launches``), or raise."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"score logits: x must be fp32 or bf16, not {x.dtype}")
    if w.dtype != x.dtype or w.device != x.device:
        raise TypeError("score logits: w must share x's dtype and device")
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"score logits: shapes {tuple(x.shape)} x "
                         f"{tuple(w.shape)} do not contract")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("score logits: x and w must be contiguous")
    B, L, D = x.shape
    TH = w.shape[1]
    lib = _bind()
    if not (0 < B <= 65535 and L > 0 and 0 < TH <= lib.score_logits_max_th()):
        raise ValueError(f"score logits: B={B}, L={L}, TH={TH} out of range "
                         f"(TH <= {lib.score_logits_max_th()})")
    out = torch.empty((B, L, TH), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.score_logits(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                           B, L, D, TH, int(x.dtype == torch.bfloat16),
                           x.device.index, stream)
    if err != 0:
        raise RuntimeError("score logits kernel launch failed: "
                           + lib.score_logits_error_string(err).decode())
    logits.launches += 1
    return out


# The logits as an operator of its own, so that torch.export keeps it as
# one node of the graph (``ips_tpu_torch::score_logits``) on either device:
# the CPU runs the plain version, the card the kernel, and the fake
# implementation gives export the output's shape and type.
@torch.library.custom_op("ips_tpu_torch::score_logits", mutates_args=(),
                         device_types="cpu")
def score_logits_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return plain_logits(x, w)


@score_logits_op.register_kernel("cuda")
def _score_logits_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _launch(x, w)


@score_logits_op.register_fake
def _score_logits_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1], w.shape[1]),
                       dtype=torch.float32)


def logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, L, D) x (D, TH) -> (B, L, TH) fp32 saliency logits, through the
    operator ``ips_tpu_torch::score_logits``.

    A CUDA tensor launches ``csrc/score_logits.cu`` (counted in
    ``logits.launches``) or raises; a CPU tensor takes
    :func:`plain_logits`.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"score logits: unsupported device {x.device}")
    return torch.ops.ips_tpu_torch.score_logits(x, w)


logits.launches = 0


def scores(x: torch.Tensor, w_eff: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel-backed scorer: (B, L, D), (D, TH) -> (B, L).

    The logits GEMM runs in x's dtype (W_eff is cast to it) with fp32
    accumulation; the epilogue runs in fp32 on the (B, L, TH) logits.
    """
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _epilogue(logits(x.contiguous(), w_eff.to(x.dtype).contiguous()),
                     mask)
