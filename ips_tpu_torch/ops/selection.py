"""The IPS selection loop with a running top-M buffer (counterpart of
ips_tpu/ops/selection.py, per-chunk path).

  * shortcut when M >= N returns all patches, unshuffled
  * the index space (not the patch tensor) is padded so every chunk has
    I candidates; padded candidates are invalid
  * the buffer starts with the first M (post-permutation) patches
  * scoring adds the positional encoding, the buffer keeps the raw
    embeddings, and the kept set is gathered from the raw patches
  * ties go to the lower candidate position, as ``lax.top_k`` breaks them

The pre-encoded and pre-permuted variants of the reference give the same
selection; they are not ported yet (ROADMAP.md queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ips_tpu_torch.constants import NEG_INF
from ips_tpu_torch.ops.shuffle import make_permutation

EncodeFn = Callable[[torch.Tensor], torch.Tensor]   # (B, n, ...) -> (B, n, D)
ScoreFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
#                   (B, L, D), (B, L) mask -> (B, L)


@dataclasses.dataclass
class SelectionResult:
    mem_patch: torch.Tensor                 # (B, M, ...) selected raw patches
    mem_pos: Optional[torch.Tensor]         # (B, M, D) positional encodings
    mem_idx: torch.Tensor                   # (B, M) original patch indices
    mem_mask: torch.Tensor                  # (B, M) bool validity
    mem_emb: Optional[torch.Tensor] = None  # (B, M, D) raw embeddings
                                            # (only with return_emb=True)


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, j], ...] -> (B, n, ...) for any trailing dims."""
    rows = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[rows, idx]


def select_top_m(emb: torch.Tensor, emb_to_score: torch.Tensor,
                 idx: torch.Tensor, valid: torch.Tensor, M: int,
                 score_fn: ScoreFn
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score L candidates, keep the top M.

    A stable descending sort keeps ``lax.top_k``'s tie order (lower
    position first); ``torch.topk`` guarantees no order among ties.
    Validity rides the kept score: invalid candidates score exactly
    NEG_INF, valid ones a softmax mean in [0, 1].
    """
    scores = score_fn(emb_to_score, valid)
    scores = torch.where(valid, scores, NEG_INF)
    top_val, top_pos = torch.sort(scores, dim=1, descending=True,
                                  stable=True)
    top_val, top_pos = top_val[:, :M], top_pos[:, :M]
    mem_emb = _gather_rows(emb, top_pos)
    mem_idx = torch.gather(idx, 1, top_pos)
    mem_valid = top_val > (0.5 * NEG_INF)
    return mem_emb, mem_idx, mem_valid


def ips_select(encode_fn: EncodeFn, score_fn: ScoreFn,
               patches: torch.Tensor, *, M: int, I: int,
               pos_table: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               shuffle: bool = False, shuffle_style: str = "batch",
               return_emb: bool = False) -> SelectionResult:
    """Iterative Patch Selection over a resident patch tensor.

    Args:
      encode_fn: eval-mode encoder, (B, n, ...) -> (B, n, D) fp32.
      score_fn: scorer, ((B, L, D), (B, L) mask) -> (B, L).
      patches: (B, N, ...) patch tensor on the device.
      pos_table: optional (N, D) positional table (by original index).
      mask: optional (B, N) bool validity for variable-N data.
      generator, shuffle, shuffle_style: tie-break randomization.
      return_emb: also return the buffer's raw (B, M, D) embeddings.
    """
    B, N = patches.shape[:2]
    device = patches.device
    full_mask = (torch.ones((B, N), dtype=torch.bool, device=device)
                 if mask is None else mask)

    # Shortcut: no selection needed (reference ips_net.py:184-188); the
    # reference returns the patches unshuffled here.
    if M >= N:
        idx = torch.arange(N, device=device).expand(B, N)
        pos = (pos_table[:N].expand(B, N, pos_table.shape[-1])
               if pos_table is not None else None)
        emb = encode_fn(patches) if return_emb else None
        return SelectionResult(patches, pos, idx, full_mask, emb)

    perm = make_permutation(generator, B, N, mask, shuffle, shuffle_style,
                            device)

    # Pad the index space so every chunk has I candidates.
    n_iter = -(-(N - M) // I)
    n_pad = M + n_iter * I - N
    if n_pad:
        perm = torch.cat([perm, perm.new_zeros((B, n_pad))], dim=1)
    # Every valid patch precedes every padded slot in perm, so validity
    # along the permuted order is position < n_valid.
    n_valid = full_mask.sum(dim=1)
    perm_valid = (torch.arange(N + n_pad, device=device)[None, :]
                  < n_valid[:, None])

    mem_idx = perm[:, :M]
    mem_valid = perm_valid[:, :M]
    mem_emb = encode_fn(_gather_rows(patches, mem_idx))
    for start in range(M, M + n_iter * I, I):
        cand_idx = perm[:, start:start + I]
        cand_emb = encode_fn(_gather_rows(patches, cand_idx))
        all_emb = torch.cat([mem_emb, cand_emb], dim=1)
        all_idx = torch.cat([mem_idx, cand_idx], dim=1)
        all_valid = torch.cat([mem_valid, perm_valid[:, start:start + I]],
                              dim=1)
        emb_to_score = (all_emb + pos_table[all_idx]
                        if pos_table is not None else all_emb)
        mem_emb, mem_idx, mem_valid = select_top_m(
            all_emb, emb_to_score, all_idx, all_valid, M, score_fn)

    mem_patch = _gather_rows(patches, mem_idx)
    mem_pos = pos_table[mem_idx] if pos_table is not None else None
    return SelectionResult(mem_patch, mem_pos, mem_idx, mem_valid,
                           mem_emb if return_emb else None)
