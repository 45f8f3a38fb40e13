"""Selection step of the trainer, inference part (counterpart of
ips_tpu/train/steps.py).

:class:`IPSTrainer` owns the model and runs eval-mode selection. The
optimizer, the train step and the fused select+train step come with the
training slice (ROADMAP.md queue 1, item 1); until then the trainer is
built without optimizer state, as ``IPSTrainer(init_opt=False)`` is in
the reference.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ips_tpu_torch.config import Config
from ips_tpu_torch.models.ips_net import DTYPES, IPSModel, init_weights
from ips_tpu_torch.models.transformer import pos_enc_1d_np
from ips_tpu_torch.ops.selection import ips_select
from ips_tpu_torch.utils.device import resolve_device


class IPSTrainer:
    """Owns the model and the eval-mode selection."""

    def __init__(self, conf: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        """Weights are drawn from ``generator`` (default: a CPU generator
        seeded with ``conf.seed``); load trained ones with
        :mod:`ips_tpu_torch.weights` or ``model.load_state_dict``."""
        self.conf = conf
        self.device = resolve_device(device)
        if conf.pretrained:
            raise NotImplementedError(
                "pretrained encoder weights are not ported yet: load them "
                "through ips_tpu_torch.weights instead")
        if generator is None:
            generator = torch.Generator().manual_seed(conf.seed)
        # module constructors draw their default init from the global
        # generator; keep the caller's global stream untouched
        with torch.random.fork_rng(devices=[]):
            self.model = IPSModel(conf)
        init_weights(self.model, generator)
        self.model.to(self.device).eval()
        self.pos_table = (torch.from_numpy(pos_enc_1d_np(conf.D, conf.N))
                          .to(self.device) if conf.use_pos else None)

    def _enc_score_fns(self):
        """(encode, score) closures for the selection pass."""
        return self.model.encode, self.model.scores

    def _select_impl(self, patches: torch.Tensor, mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     return_emb: bool = False):
        """Eval-mode IPS over a (B, N, ...) patch tensor on the device.

        Returns (mem_patch, mem_pos, mem_idx, mem_mask), plus the buffer's
        raw (B, M, D) embeddings with ``return_emb=True``.
        """
        conf = self.conf
        if conf.input_dtype == "bfloat16" and patches.dtype != torch.uint8:
            # one up-front cast halves the bytes of every chunk gather
            patches = patches.to(DTYPES[conf.input_dtype])
        encode, score = self._enc_score_fns()
        res = ips_select(encode, score, patches, M=conf.M, I=conf.I,
                         pos_table=self.pos_table, mask=mask,
                         generator=generator, shuffle=conf.shuffle,
                         shuffle_style=conf.shuffle_style,
                         return_emb=return_emb)
        out = (res.mem_patch, res.mem_pos, res.mem_idx, res.mem_mask)
        return out + (res.mem_emb,) if return_emb else out

    def _reuse_eval_emb(self) -> bool:
        """Inference may consume the selection buffer's embeddings:
        selection runs the encoder in the same eval mode the forward
        would, so re-encoding the M survivors recomputes the same values."""
        return self.conf.eval_reuse_emb and self.conf.select_dtype != "int8"
