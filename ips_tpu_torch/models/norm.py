"""Weight-aware BatchNorm (counterpart of ips_tpu/models/norm.py).

Parameters and statistics are kept in fp32 and the output is fp32,
whatever the input's dtype, as in the reference. Only the eval path
(running statistics) is ported: the row-weighted batch statistics of
training come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over dim 1 of (N, C, ...) with torch's eps (1e-5)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, use_running_average: bool = True,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not use_running_average:
            raise NotImplementedError(
                "train-mode (row-weighted) batch statistics are not ported "
                "yet: ROADMAP.md queue 1, item 1 (training)")
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = ((x.float() - self.running_mean.view(shape))
             * torch.rsqrt(self.running_var + self.epsilon).view(shape))
        return y * self.weight.view(shape) + self.bias.view(shape)
