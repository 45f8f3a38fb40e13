"""IPSModel — encoder + cross-attention transformer + per-task heads
(counterpart of ips_tpu/models/ips_net.py).

  * ``encode``    — (B, n, ph, pw, C) patches or (B, n, F) feature rows
                    -> (B, n, D) fp32 embeddings
  * ``scores``    — per-candidate saliency; 'fast' and 'pallas' run the
                    query-folded scorer, whose logits GEMM is the CUDA
                    kernel on the card (ops/score_kernel.py); 'attn' runs
                    the reference-shaped attention path
  * ``aggregate`` — cross-attention pooling -> (B, n_token, D)
  * ``predict``   — per-task heads: Linear -> softmax/sigmoid
  * ``forward``   — the forward over the M selected patches; with
                    ``train=True`` batch statistics (weighted by instance)
                    and dropout, as the gradient step runs it

Submodule names follow the reference's parameter tree (``encoder``,
``transf``, ``head_<task>``) so the weight bridge maps names one to one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ips_tpu_torch.config import Config
from ips_tpu_torch.models.encoders import (Conv, ConvPatchEncoder,
                                           FeatureProjector, encoder_out_dim)
from ips_tpu_torch.models.transformer import (CrossAttnTransformer,
                                              MultiHeadCrossAttention)
from ips_tpu_torch.ops import score_kernel
from ips_tpu_torch.utils.imagenet import IMAGENET_MEAN, IMAGENET_STD

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class IPSModel(nn.Module):
    def __init__(self, conf: Config):
        super().__init__()
        self.conf = conf
        dtype = DTYPES[conf.compute_dtype]
        if conf.is_image:
            d_enc = encoder_out_dim(conf.enc_type, conf.n_res_blocks)
            if d_enc != conf.D:
                raise ValueError(
                    f"encoder output dim {d_enc} != D={conf.D}; the "
                    "reference relies on these matching (ips_net.py:209-210)")
            self.encoder = ConvPatchEncoder(conf.enc_type, conf.n_chan_in,
                                            conf.n_res_blocks, conf.s2d_stem,
                                            dtype)
        else:
            self.encoder = FeatureProjector(conf.n_chan_in, conf.D, dtype,
                                            conf.ln_fold)
        self.transf = CrossAttnTransformer(
            conf.n_token, conf.H, conf.D, conf.D_k, conf.D_v, conf.D_inner,
            conf.attn_dropout, conf.dropout, dtype)
        for task in conf.task_list:
            self.add_module(f"head_{task.name}",
                            nn.Linear(conf.D, conf.n_class))
        if conf.input_norm == "imagenet":
            self.register_buffer("in_mean", torch.from_numpy(IMAGENET_MEAN),
                                 persistent=False)
            self.register_buffer("in_std", torch.from_numpy(IMAGENET_STD),
                                 persistent=False)

    def encode(self, x: torch.Tensor, train: bool = False,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encode patches (B, n, ph, pw, C) or features (B, n, F) ->
        (B, n, D) fp32.

        uint8 patches are scaled to [0, 1] per chunk, so the resident
        patch tensor can stay uint8. ``weights`` (B,) keeps zero-weight
        instances out of the batch statistics of training.
        """
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        if self.conf.input_norm == "imagenet":
            x = (x.float() - self.in_mean) / self.in_std
        lead = x.shape[:2]
        row_w = (weights.repeat_interleave(lead[1]) if weights is not None
                 else None)
        emb = self.encoder(x.reshape((lead[0] * lead[1],) + x.shape[2:]),
                           train, row_w)
        return emb.reshape(lead + (self.conf.D,))

    def score_weights(self) -> torch.Tensor:
        """W_eff (D, T*H): the query folded into the key projection."""
        att = self.transf.crs_attn
        return score_kernel.fold_query(att.q, att.q_w.weight.t(),
                                       att.k_w.weight.t(), self.conf.H,
                                       self.conf.D_k)

    def scores(self, emb: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Saliency scores (B, L) from embeddings (B, L, D)."""
        if self.conf.score_impl == "attn":
            return self.transf.get_scores(emb, mask)
        return score_kernel.scores(emb.float(), self.score_weights(), mask)

    def aggregate(self, emb: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        return self.transf(emb, mask, train, generator)

    def predict(self, image_emb: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-task prediction from the (B, n_token, D) aggregate."""
        preds = {}
        for task in self.conf.task_list:
            logit = getattr(self, f"head_{task.name}")(image_emb[:, task.id])
            preds[task.name] = (torch.softmax(logit, dim=-1)
                                if task.act_fn == "softmax"
                                else torch.sigmoid(logit))
        return preds

    def forward(self, mem_patch: torch.Tensor,
                mem_pos: Optional[torch.Tensor] = None,
                mem_mask: Optional[torch.Tensor] = None, train: bool = False,
                weights: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        emb = self.encode(mem_patch, train, weights)
        if mem_pos is not None:
            emb = emb + mem_pos
        return self.predict(self.aggregate(emb, mem_mask, train, generator))


@torch.no_grad()
def init_weights(model: IPSModel, generator: torch.Generator) -> None:
    """The reference's initializers, drawn from ``generator``:
    convs kaiming-normal (fan_out, relu), Linear weight and bias
    U(+-1/sqrt(fan_in)), query tokens U(+-sqrt(1/D_k)); norms start at
    scale 1, bias 0, running mean 0 and variance 1."""
    def uniform_(t, bound):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                              generator=generator))

    for module in model.modules():
        if isinstance(module, Conv):
            w = module.weight
            fan_out = w.shape[0] * w.shape[2] * w.shape[3]
            w.copy_(torch.empty(w.shape).normal_(
                0.0, math.sqrt(2.0 / fan_out), generator=generator))
        elif isinstance(module, nn.Linear):
            bound = 1.0 / math.sqrt(module.in_features)
            uniform_(module.weight, bound)
            if module.bias is not None:
                uniform_(module.bias, bound)
        elif isinstance(module, MultiHeadCrossAttention):
            uniform_(module.q, math.sqrt(1.0 / module.D_k))
