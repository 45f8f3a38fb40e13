"""Fused eval-mode ResNet BasicBlock (counterpart of
scripts/probe_conv.py:pallas_block and its ``_pallas_block_kernel``).

    h = bf16(relu(conv3x3(x, w1) * s1 + b1))
    y = bf16(relu(conv3x3(h, w2) * s2 + b2 + float(x)))

Convs are 3x3, stride 1, zero padding 1, with fp32 accumulation; the BN
of each conv is folded into a per-channel scale and shift. Layouts are
the JAX kernel's: x (n, s, s, c) bf16 NHWC; ``q`` holds ``w1``, ``w2``
(9, c, c) bf16 tap-major HWIO and ``s1``, ``b1``, ``s2``, ``b2`` (c,)
fp32 (:func:`kernel_params` makes them from the probe's (3, 3, c, c)
weights).

On a CUDA tensor :func:`fused_block` launches the hand-written kernel
``csrc/conv_block.cu`` (counted in ``fused_block.launches``) or raises;
on a CPU tensor it runs :func:`plain_fused_block`, the same function in
plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ips_tpu_torch.utils.cuda_build import load_library

_KERNEL = "conv_block"
_WEIGHTS = ("w1", "w2")
_VECTORS = ("s1", "b1", "s2", "b2")

Params = Dict[str, torch.Tensor]


def kernel_params(p: Params) -> Params:
    """Probe parameters (``w*`` (3, 3, c, c)) -> the kernel's layout
    (``w*`` (9, c, c), vectors (c,)), all contiguous."""
    c = p["w1"].shape[-1]
    q = {k: p[k].reshape(9, c, c).contiguous() for k in _WEIGHTS}
    q.update({k: p[k].reshape(c).contiguous() for k in _VECTORS})
    return q


def conv_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 conv as nine products on shifted slices, in fp32 on the values
    widened: (n, s, s, c) x (9, c, c) -> (n, s, s, c) fp32."""
    s = x.shape[1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    w = w.float()
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        term = xp[:, dy:dy + s, dx:dx + s, :] @ w[t]
        acc = term if acc is None else acc + term
    return acc


def eval_block(conv: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               x: torch.Tensor, p: Params) -> torch.Tensor:
    """The block around a given conv, rounding where the reference does:
    h to bf16 before conv 2, the output to bf16; fp32 in between."""
    h = torch.relu(conv(x, p["w1"]) * p["s1"] + p["b1"]).to(torch.bfloat16)
    y = conv(h, p["w2"]) * p["s2"] + p["b2"]
    return torch.relu(y + x.float()).to(torch.bfloat16)


def plain_fused_block(x: torch.Tensor, q: Params) -> torch.Tensor:
    """Plain version of the kernel (the kernel's parameter layout)."""
    return eval_block(conv_taps, x, q)


def _check(x: torch.Tensor, q: Params) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 4 or x.shape[1] != x.shape[2]:
        raise ValueError(f"fused block: x must be (n, s, s, c) bf16, not "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[3]
    for k in _WEIGHTS:
        if q[k].dtype != torch.bfloat16 or tuple(q[k].shape) != (9, c, c):
            raise ValueError(f"fused block: {k} must be (9, {c}, {c}) bf16, "
                             f"not {tuple(q[k].shape)} {q[k].dtype}")
    for k in _VECTORS:
        if q[k].dtype != torch.float32 or tuple(q[k].shape) != (c,):
            raise ValueError(f"fused block: {k} must be ({c},) fp32, not "
                             f"{tuple(q[k].shape)} {q[k].dtype}")


@functools.cache
def _bind() -> ctypes.CDLL:
    lib = load_library(_KERNEL)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_block.argtypes = [p] * 8 + [i, i, i, i, p]
    lib.conv_block.restype = i
    lib.conv_block_error_string.argtypes = [i]
    lib.conv_block_error_string.restype = ctypes.c_char_p
    lib.conv_block_max_s.argtypes = []
    lib.conv_block_max_s.restype = i
    lib.conv_block_supports_c.argtypes = [i]
    lib.conv_block_supports_c.restype = i
    return lib


def fused_block(x: torch.Tensor, q: Params) -> torch.Tensor:
    """One fused BasicBlock: (n, s, s, c) bf16 -> (n, s, s, c) bf16.

    A CUDA tensor launches ``csrc/conv_block.cu`` or raises; a CPU tensor
    takes :func:`plain_fused_block`.
    """
    _check(x, q)
    if x.device.type == "cpu":
        return plain_fused_block(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"fused block: unsupported device {x.device}")
    tensors = (x, *(q[k] for k in (*_WEIGHTS, *_VECTORS)))
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused block: x and q must share one device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("fused block: x and q must be contiguous and "
                         "16-byte aligned")
    n, s, _, c = x.shape
    lib = _bind()
    if not (0 < n < 2**31 and 0 < s <= lib.conv_block_max_s()
            and lib.conv_block_supports_c(c)):
        raise ValueError(f"fused block: n={n}, s={s}, c={c} out of range "
                         f"(s <= {lib.conv_block_max_s()}, c in 32, 64, "
                         "128)")
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.conv_block(x.data_ptr(), q["w1"].data_ptr(),
                         q["s1"].data_ptr(), q["b1"].data_ptr(),
                         q["w2"].data_ptr(), q["s2"].data_ptr(),
                         q["b2"].data_ptr(), out.data_ptr(), n, s, c,
                         x.device.index, stream)
    if err != 0:
        raise RuntimeError("fused block kernel launch failed: "
                           + lib.conv_block_error_string(err).decode())
    fused_block.launches += 1
    return out


fused_block.launches = 0
