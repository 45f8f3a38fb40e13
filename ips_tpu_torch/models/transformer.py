"""Learnable-query cross-attention transformer (counterpart of
ips_tpu/models/transformer.py): aggregator and patch scorer.

  * learnable query tokens ``q`` (1, n_token, D)
  * q/k/v/out projections without bias
  * attention = softmax(q k^T / sqrt(D_k)) over the L candidates; masked
    candidates take the finite ``NEG_INF`` logit
  * the residual adds the *raw* query parameter, then LayerNorm(eps=1e-6)
  * two-layer ReLU MLP with residual and LayerNorm(eps=1e-6)
  * patch saliency = attention averaged over heads, then over tokens

Parameters stay fp32; each projection computes in the compute dtype and
the attention products accumulate in fp32, as in the reference. In
training (``train=True``) dropout acts where the reference's does: on the
attention weights after the softmax, on the output projection and on the
MLP's second layer, each mask drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ips_tpu_torch.constants import NEG_INF
from ips_tpu_torch.parallel.mesh import rand_rows


def pos_enc_1d_np(D: int, len_seq: int) -> np.ndarray:
    """Host sin/cos positional table (len_seq, D): sin on even dims, cos
    on odd (reference transformer.py:6-18)."""
    if D % 2 != 0:
        raise ValueError(f"pos_enc_1d needs even D, got {D}")
    position = np.arange(len_seq, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, D, 2, dtype=np.float32)
                      * -(math.log(10000.0) / D))
    ang = position * div_term
    pe = np.stack([np.sin(ang), np.cos(ang)], axis=-1)
    return pe.reshape(len_seq, D).astype(np.float32)


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - p and
    scale the kept ones by 1 / (1 - p); the identity unless training with
    p > 0. The mask is drawn from ``generator``, which must live on x's
    device."""
    if not train or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    # the global batch's mask under data parallelism (parallel/mesh.py)
    keep = rand_rows(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


def dense(layer: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=)``: input, weight and bias cast to dtype;
    the product is rounded to dtype before the bias is added in dtype, as
    flax adds it (``F.linear`` with the bias would round once)."""
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y + layer.bias.to(dtype) if layer.bias is not None else y


class MultiHeadCrossAttention(nn.Module):
    """Multi-head cross-attention with learnable query tokens."""

    def __init__(self, n_token: int, H: int, D: int, D_k: int, D_v: int,
                 attn_dropout: float = 0.1, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_token, self.H, self.D, self.D_k, self.D_v = (
            n_token, H, D, D_k, D_v)
        self.attn_dropout, self.dropout = attn_dropout, dropout
        self.dtype = dtype
        self.q = nn.Parameter(torch.zeros(1, n_token, D))
        self.q_w = nn.Linear(D, H * D_k, bias=False)
        self.k_w = nn.Linear(D, H * D_k, bias=False)
        self.v_w = nn.Linear(D, H * D_v, bias=False)
        self.fc = nn.Linear(H * D_v, D, bias=False)
        self.layer_norm = nn.LayerNorm(D, eps=1e-6)

    def _attn_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> logits (B, H, n_token, L), fp32."""
        B, L = x.shape[:2]
        q = dense(self.q_w, self.q, self.dtype).reshape(
            1, self.n_token, self.H, self.D_k).transpose(1, 2)
        k = dense(self.k_w, x, self.dtype).reshape(
            B, L, self.H, self.D_k).transpose(1, 2)
        logits = torch.einsum("xhtd,bhld->bhtl", q.float(), k.float())
        return logits / math.sqrt(self.D_k)

    def attn_weights(self, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention weights (B, H, n_token, L); mask (B, L) bool."""
        logits = self._attn_logits(x)
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
        return torch.softmax(logits, dim=-1)

    def get_scores(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Per-patch saliency (B, L): mean over heads, then tokens."""
        return self.attn_weights(x, mask).mean(dim=1).mean(dim=1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, L = x.shape[:2]
        attn = dropout(self.attn_weights(x, mask), self.attn_dropout, train,
                       generator)
        v = dense(self.v_w, x, self.dtype).reshape(
            B, L, self.H, self.D_v).transpose(1, 2)
        out = torch.einsum("bhtl,bhld->bhtd", attn.to(v.dtype).float(),
                           v.float())
        out = out.transpose(1, 2).reshape(B, self.n_token,
                                          self.H * self.D_v)
        out = dropout(dense(self.fc, out, self.dtype), self.dropout, train,
                      generator)
        # residual on the raw learnable query (reference transformer.py:106)
        return self.layer_norm(out.float() + self.q)


class MLP(nn.Module):
    """Two-layer feed-forward with residual + LayerNorm."""

    def __init__(self, D: int, D_inner: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.w_1 = nn.Linear(D, D_inner)
        self.w_2 = nn.Linear(D_inner, D)
        self.layer_norm = nn.LayerNorm(D, eps=1e-6)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = F.relu(dense(self.w_1, x, self.dtype))
        h = dropout(dense(self.w_2, h, self.dtype), self.dropout, train,
                    generator)
        return self.layer_norm(h.float() + x)


class CrossAttnTransformer(nn.Module):
    """One cross-attention block + MLP; doubles as scorer and aggregator."""

    def __init__(self, n_token: int, H: int, D: int, D_k: int, D_v: int,
                 D_inner: int, attn_dropout: float = 0.1,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.crs_attn = MultiHeadCrossAttention(
            n_token, H, D, D_k, D_v, attn_dropout, dropout, dtype)
        self.mlp = MLP(D, D_inner, dropout, dtype)

    def get_scores(self, x: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L, D) -> (B, L) saliency scores."""
        return self.crs_attn.get_scores(x, mask)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, D) -> (B, n_token, D) aggregated image embedding."""
        return self.mlp(self.crs_attn(x, mask, train, generator), train,
                        generator)
