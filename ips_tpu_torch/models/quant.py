"""int8-quantized selection encoder, ``select_dtype: int8`` (counterpart of
ips_tpu/models/quant.py).

Selection is a no-grad, eval-mode scoring pass: its embeddings only rank
patches and are thrown away, and the M survivors are re-encoded in full
precision for the gradient step. That makes selection the one place
where int8 arithmetic is offered.

The scheme is the JAX package's (post-training dynamic quantization):

  * weights: symmetric per-output-channel int8, made from the same fp32
    parameters the full-precision path uses, once per selection;
  * activations: symmetric per-tensor dynamic int8 (scale from max |x| of
    each tensor), rounded half to even;
  * each conv accumulates int8 x int8 in int32, dequantizes to fp32
    (``acc * (s_x * s_k)``), then applies the folded eval-mode BatchNorm
    (``y * scale + shift``), ReLU and the residual adds in fp32.

The int8 convolution is an im2col of the int8 activations in NHWC order,
matching the kernel flattened in (kh, kw, C) order, followed by
``torch._int_mm`` (cuBLASLt's int8 GEMM with int32 accumulation on the
card, the same op on the CPU). The JAX package leaves its int8 convolution
to XLA (``lax.conv_general_dilated``, no Pallas kernel), and torch has no
eager int8 convolution on CUDA. The sums are exact integers on either
device. ``_int_mm`` on the card takes more than 16 rows and a depth and
width that are multiples of 8, so the operands are zero-padded to that
(the 7x7 stem's depth is 49 or 147), which adds nothing to any sum.

Everything is NHWC here; the encoder's parameters are read from the
port's :class:`~ips_tpu_torch.models.encoders.ConvPatchEncoder`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ips_tpu_torch.models.encoders import (BasicBlock, BottleneckBlock,
                                           ConvPatchEncoder)
from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.utils.imagenet import IMAGENET_MEAN, IMAGENET_STD

_QMAX = 127.0


def _fold_bn(bn: MaskedBatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode BN -> per-channel (scale, shift): y = x*scale + shift,
    with the encoder's own epsilon."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.epsilon)
    return inv, bn.bias - bn.running_mean * inv


def _quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor dynamic int8 quantization: (q, scale)."""
    s = torch.clamp(x.abs().amax(), min=1e-6) / _QMAX
    q = torch.clamp(torch.round(x / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def _quant_kernel(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an OIHW kernel: (q, (O,)
    scales)."""
    s = torch.clamp(k.abs().amax(dim=(1, 2, 3)), min=1e-8) / _QMAX
    q = torch.clamp(torch.round(k / s[:, None, None, None]), -_QMAX,
                    _QMAX).to(torch.int8)
    return q, s


def _pad_to(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, extra]
    return F.pad(t, pad)


def int8_conv(xq: torch.Tensor, kq: torch.Tensor, stride: int = 1,
              padding: int = 0) -> torch.Tensor:
    """(n, H, W, C) int8 x (O, C, kh, kw) int8 -> (n, Ho, Wo, O) int32,
    the exact sums of ``lax.conv_general_dilated(...,
    preferred_element_type=int32)`` with zero padding."""
    n, H, W, C = xq.shape
    O, _, kh, kw = kq.shape
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    if kh == kw == 1:
        win = xq[:, ::stride, ::stride]
        Ho, Wo = win.shape[1:3]
        cols = win.reshape(-1, C)
    else:
        win = xq.unfold(1, kh, stride).unfold(2, kw, stride)
        Ho, Wo = win.shape[1:3]                  # (n, Ho, Wo, C, kh, kw)
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * C)
    rows, K = cols.shape
    kmat = kq.permute(0, 2, 3, 1).reshape(O, K)   # (O, (kh, kw, C))
    K8, O8 = -(-K // 8) * 8, -(-O // 8) * 8
    cols = _pad_to(_pad_to(cols, 1, K8), 0, 17)
    kmat = _pad_to(_pad_to(kmat, 1, K8), 0, O8)
    # kmat.t() is column-major: the (row-major A, column-major B) layout
    # that cuBLASLt's int8 GEMM takes on every architecture
    acc = torch._int_mm(cols.contiguous(), kmat.contiguous().t())
    return acc[:rows, :O].reshape(n, Ho, Wo, O)


class _QConv:
    """One conv of the encoder, quantized once: its int8 kernel and
    per-channel scales, stride, padding and folded BatchNorm."""

    def __init__(self, conv: torch.nn.Conv2d, bn: Optional[MaskedBatchNorm]):
        self.kq, self.s_k = _quant_kernel(conv.weight.detach().float())
        self.stride, self.padding = conv.stride[0], conv.padding[0]
        self.bn = None if bn is None else tuple(
            t.detach() for t in _fold_bn(bn))

    def __call__(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        return _qconv(x, self.kq, self.s_k, stride=self.stride,
                      padding=self.padding, bn=self.bn, relu=relu)


def _qconv(x: torch.Tensor, kq: torch.Tensor, s_k: torch.Tensor, *,
           stride: int = 1, padding: int = 1,
           bn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           relu: bool = False) -> torch.Tensor:
    """int8 conv with int32 accumulation, fp32 dequant + folded BN, on an
    (n, H, W, C) fp32 input and an int8 OIHW kernel with its scales."""
    xq, s_x = _quant_act(x)
    y = int8_conv(xq, kq, stride, padding).float()
    y.mul_(s_x * s_k)
    if bn is not None:
        y.mul_(bn[0]).add_(bn[1])
    return y.relu_() if relu else y


def _basic_block(x: torch.Tensor, q: Dict[str, _QConv]) -> torch.Tensor:
    y = q["conv1"](x, relu=True)
    y = q["conv2"](y)
    res = q["downsample"](x) if "downsample" in q else x
    return (y + res).relu_()


def _bottleneck_block(x: torch.Tensor, q: Dict[str, _QConv]) -> torch.Tensor:
    y = q["conv1"](x, relu=True)
    y = q["conv2"](y, relu=True)
    y = q["conv3"](y)
    res = q["downsample"](x) if "downsample" in q else x
    return (y + res).relu_()


class QuantEncoder:
    """The int8 eval-mode forward of a ConvPatchEncoder over its current
    weights and running statistics: (n, H, W, C) patches -> (n, D) fp32.

    Mirrors ConvPatchEncoder.forward in eval mode: stem conv 7x7/2 + BN +
    ReLU + 3x3/2 maxpool, the truncated stages, global average pooling.
    """

    def __init__(self, encoder: ConvPatchEncoder, input_norm: str = "none"):
        self.input_norm = input_norm
        self.stem = _QConv(encoder.conv1, encoder.bn1)
        self.blocks: List[Tuple[Callable, Dict[str, _QConv]]] = []
        for name in encoder.block_names:
            blk = getattr(encoder, name)
            convs = (("conv1", "bn1"), ("conv2", "bn2"))
            if isinstance(blk, BottleneckBlock):
                convs += (("conv3", "bn3"),)
                fn = _bottleneck_block
            elif isinstance(blk, BasicBlock):
                fn = _basic_block
            else:
                raise TypeError(f"{name}: {type(blk).__name__} has no int8 "
                                "form")
            q = {c: _QConv(getattr(blk, c), getattr(blk, b))
                 for c, b in convs}
            if hasattr(blk, "downsample_conv"):
                q["downsample"] = _QConv(blk.downsample_conv,
                                         blk.downsample_bn)
            self.blocks.append((fn, q))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = x.float()
        if self.input_norm == "imagenet":
            x = ((x - torch.from_numpy(IMAGENET_MEAN).to(x.device))
                 / torch.from_numpy(IMAGENET_STD).to(x.device))
        y = self.stem(x, relu=True)
        # lax.reduce_window with -inf padding is max_pool2d's padding
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for fn, q in self.blocks:
            y = fn(y, q)
        return y.mean(dim=(1, 2))


@torch.no_grad()
def quant_encode_patches(encoder: ConvPatchEncoder, x: torch.Tensor,
                         input_norm: str = "none") -> torch.Tensor:
    """(n, H, W, C) patches -> (n, D) embeddings, int8 conv arithmetic."""
    return QuantEncoder(encoder, input_norm)(x)


def make_quant_encode_fn(model, conf) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Selection encode (B, n, ...) -> (B, n, D) with int8 convs over the
    model's current encoder weights, quantized once here: the drop-in
    encode of ``IPSTrainer._enc_score_fns`` for ``select_dtype: int8``."""
    with torch.no_grad():
        enc = QuantEncoder(model.encoder, conf.input_norm)

    def encode(x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:2]
        emb = enc(x.reshape((lead[0] * lead[1],) + x.shape[2:]))
        return emb.reshape(lead + (emb.shape[-1],))

    return encode
