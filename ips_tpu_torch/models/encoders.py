"""Patch encoders (counterpart of ips_tpu/models/encoders.py): a
truncated ResNet over image patches and a projector over precomputed
features.

torchvision-style ResNet-18/50 cut after layer2 (``n_res_blocks=2``) or
layer4 (``n_res_blocks=4``), with the 7x7 stem rebuilt for ``n_chan_in``
channels, ending in global average pooling. Tensors are NCHW in
channels_last memory, so a (n, H, W, C) patch batch enters as a view.

As in the reference, parameters stay fp32 and every conv casts its input
and weight to the compute dtype; BatchNorm outputs fp32, so activations
between convs, the residual sums and the pooled output are fp32. ``train``
and ``row_weights`` reach every norm: batch statistics weighted by row in
training, running statistics otherwise.

``FeatureProjector`` (feature mode, ``is_image: false``) maps precomputed
feature rows to D: LayerNorm without affine, Linear, ``MaskedBatchNorm``,
ReLU, fp32 out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ips_tpu_torch.models.norm import MaskedBatchNorm
from ips_tpu_torch.models.transformer import dense

_STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


def encoder_out_dim(enc_type: str, n_res_blocks: int) -> int:
    """Feature dim after truncation (128/512 for r18, 512/2048 for r50)."""
    if enc_type == "resnet18":
        return 128 if n_res_blocks == 2 else 512
    return 512 if n_res_blocks == 2 else 2048


class Conv(nn.Conv2d):
    """Bias-free conv that computes in ``dtype`` (flax ``nn.Conv(dtype=)``)."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__(c_in, c_out, k, stride=stride, padding=padding,
                         bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype), None)


class StemConv(Conv):
    """7x7/stride-2 stem. The reference's space-to-depth form (``s2d``)
    is a TPU reformulation with the same output, so the port runs the
    plain conv for either setting."""

    def __init__(self, n_chan_in: int, s2d: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(n_chan_in, 64, 7, stride=2, padding=3, dtype=dtype)
        self.s2d = s2d


class BasicBlock(nn.Module):
    """ResNet-18/34 residual block (3x3 -> 3x3)."""

    def __init__(self, c_in: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(c_in, filters, 3, stride, 1, dtype)
        self.bn1 = MaskedBatchNorm(filters)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype)
        self.bn2 = MaskedBatchNorm(filters)
        if c_in != filters or stride != 1:
            self.downsample_conv = Conv(c_in, filters, 1, stride, 0, dtype)
            self.downsample_bn = MaskedBatchNorm(filters)

    def forward(self, x: torch.Tensor, train: bool = False,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        def norm(bn, h):
            return bn(h, use_running_average=not train, weights=row_weights)
        y = F.relu(norm(self.bn1, self.conv1(x)))
        y = norm(self.bn2, self.conv2(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = norm(self.downsample_bn, self.downsample_conv(x))
        return F.relu(y + residual)


class BottleneckBlock(nn.Module):
    """ResNet-50 residual block (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, c_in: int, width: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = width * 4
        self.conv1 = Conv(c_in, width, 1, 1, 0, dtype)
        self.bn1 = MaskedBatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride, 1, dtype)
        self.bn2 = MaskedBatchNorm(width)
        self.conv3 = Conv(width, out_ch, 1, 1, 0, dtype)
        self.bn3 = MaskedBatchNorm(out_ch)
        if c_in != out_ch or stride != 1:
            self.downsample_conv = Conv(c_in, out_ch, 1, stride, 0, dtype)
            self.downsample_bn = MaskedBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        def norm(bn, h):
            return bn(h, use_running_average=not train, weights=row_weights)
        y = F.relu(norm(self.bn1, self.conv1(x)))
        y = F.relu(norm(self.bn2, self.conv2(y)))
        y = norm(self.bn3, self.conv3(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = norm(self.downsample_bn, self.downsample_conv(x))
        return F.relu(y + residual)


class ConvPatchEncoder(nn.Module):
    """Truncated ResNet over (n, H, W, C) patches -> (n, D_out) fp32.

    Submodule names follow the reference's parameter tree
    (``conv1``, ``bn1``, ``layer<s>_block<b>``) so that the weight bridge
    maps names one to one.
    """

    def __init__(self, enc_type: str = "resnet18", n_chan_in: int = 3,
                 n_res_blocks: int = 2, s2d_stem: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        blocks = _STAGE_BLOCKS[enc_type]
        bottleneck = enc_type == "resnet50"
        self.conv1 = StemConv(n_chan_in, s2d_stem, dtype)
        self.bn1 = MaskedBatchNorm(64)
        self.block_names = []
        c_in = 64
        for stage in range(2 if n_res_blocks == 2 else 4):
            width = 64 * (2 ** stage)
            for b in range(blocks[stage]):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                name = f"layer{stage + 1}_block{b}"
                if bottleneck:
                    blk = BottleneckBlock(c_in, width, stride, dtype)
                    c_in = width * 4
                else:
                    blk = BasicBlock(c_in, width, stride, dtype)
                    c_in = width
                self.add_module(name, blk)
                self.block_names.append(name)

    def forward(self, x: torch.Tensor, train: bool = False,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (n, H, W, C) -> (n, D_out); row_weights (n,) keeps padded
        rows out of the batch statistics of training."""
        y = x.permute(0, 3, 1, 2)          # NHWC -> NCHW, channels_last view
        y = F.relu(self.bn1(self.conv1(y), use_running_average=not train,
                            weights=row_weights))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for name in self.block_names:
            y = getattr(self, name)(y, train, row_weights)
        return y.mean(dim=(2, 3), dtype=torch.float32)


class FeatureProjector(nn.Module):
    """Projector for precomputed features: LN(no affine) -> Linear -> BN
    -> ReLU, (n, F) -> (n, D) fp32.

    The LayerNorm statistics are flax's, in fp32: the fast variance
    max(0, E[x^2] - E[x]^2), eps 1e-5. Exact form: the normalized rows
    (in x's dtype) go through the Linear in the compute dtype, rows,
    weight and bias rounded to it and the output in it, as flax's
    ``Dense(dtype=)``. ``ln_fold``: the row affine commutes through the
    Linear,

        ((x - m) * r) @ W + b  ==  r * (x @ W) - (r * m) * colsum(W) + b,

    so the GEMM reads the raw rows in the compute dtype with fp32
    accumulation (the products of two bf16 values are exact in fp32, so
    the fp32 GEMM of the rounded operands is that product) and the
    affine runs in fp32 before one cast to the compute dtype. Both forms
    share the parameters: ``fc`` (Linear) and ``bn``.
    """

    def __init__(self, n_chan_in: int, D: int,
                 dtype: torch.dtype = torch.float32, ln_fold: bool = False):
        super().__init__()
        self.dtype = dtype
        self.ln_fold = ln_fold
        self.fc = nn.Linear(n_chan_in, D)
        self.bn = MaskedBatchNorm(D)

    def forward(self, x: torch.Tensor, train: bool = False,
                row_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        mu2 = xf.square().mean(dim=-1, keepdim=True)
        r = torch.rsqrt(torch.clamp(mu2 - mu.square(), min=0.0) + 1e-5)
        if not self.ln_fold:
            y = dense(self.fc, ((xf - mu) * r).to(x.dtype), self.dtype)
        else:
            kb = self.fc.weight.to(self.dtype)              # (D, F)
            z = x.to(self.dtype).float() @ kb.float().t()
            colsum = kb.float().sum(dim=1)
            y = (z * r - (r * mu) * colsum + self.fc.bias).to(self.dtype)
        y = self.bn(y, use_running_average=not train, weights=row_weights)
        return F.relu(y).float()
