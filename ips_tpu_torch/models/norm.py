"""Weight-aware BatchNorm (counterpart of ips_tpu/models/norm.py).

Parameters and statistics are kept in fp32 and the output is fp32,
whatever the input's dtype, as in the reference. In training the batch
statistics are row-weighted, so zero-weight (padded) instances of a
partial batch stay out of them; with all-ones weights, or none, they are
plain BatchNorm's.

Under data parallelism (``group``: the ranks that split the batch rows)
the batch statistics are those of the global batch, as GSPMD's inserted
sums make them in the JAX package: two differentiable all-reduces, of
``sum(w x)`` with the count, then of ``sum(w (x - mean)^2)`` around the
global mean. Their backward sums the gradient over the group, as JAX's
transpose of the sum does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over a process group; its backward sums the
    incoming gradients over the group, as the transpose of the sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _GroupSum.apply(grad, ctx.group), None


def _group_sum(t: torch.Tensor, group) -> torch.Tensor:
    return _GroupSum.apply(t, group)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over dim 1 of (N, C, ...) with torch's eps (1e-5) and the
    flax momentum convention: ``ra = m * ra + (1 - m) * stat``, m = 0.9."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # the data-parallel group of the batch statistics (None: this
        # process's batch is the whole batch)
        self.group = None

    def forward(self, x: torch.Tensor, use_running_average: bool = True,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, C, ...); weights: optional (N,) row weights, used only
        for the batch statistics of training."""
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if use_running_average:
            # no name is bound to the fp32 copy or the centered tensor, so
            # each is freed as soon as the next op has read it (the eval
            # encode's peak memory)
            y = ((x.float() - self.running_mean.view(shape))
                 * torch.rsqrt(self.running_var + self.epsilon).view(shape))
        else:
            xc, var = self._centered(x.float(), weights)
            y = xc * torch.rsqrt(var + self.epsilon).view(shape)
        return y * self.weight.view(shape) + self.bias.view(shape)

    def _centered(self, x32: torch.Tensor, weights: Optional[torch.Tensor]):
        """x32 minus its row-weighted batch mean, and the biased variance
        (two-pass), over max(sum(w) * H * W, 1) values; updates the
        running statistics."""
        shape = (1, -1) + (1,) * (x32.dim() - 2)
        dims = [0] + list(range(2, x32.dim()))
        if weights is None:
            w = torch.ones((), device=x32.device)
            count = torch.tensor(float(x32.numel() // x32.shape[1]),
                                 device=x32.device)
        else:
            w = weights.float().view((-1,) + (1,) * (x32.dim() - 1))
            per_row = x32.numel() // (x32.shape[0] * x32.shape[1])
            count = w.sum() * per_row
        if self.group is None:
            if weights is not None:
                count = torch.clamp(count, min=1.0)
            mean = (x32 * w).sum(dims) / count
            xc = x32 - mean.view(shape)
            var = (xc ** 2 * w).sum(dims) / count
        else:
            sums = _group_sum(torch.cat([(x32 * w).sum(dims),
                                         count.reshape(1)]), self.group)
            count = torch.clamp(sums[-1].detach(), min=1.0)
            mean = sums[:-1] / count
            xc = x32 - mean.view(shape)
            var = _group_sum((xc ** 2 * w).sum(dims), self.group) / count
        with torch.no_grad():
            # normalization uses the biased variance; the running one
            # stores the Bessel-corrected value, as torch does
            m = self.momentum
            bessel = count / torch.clamp(count - 1.0, min=1.0)
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var * bessel)
        return xc, var
