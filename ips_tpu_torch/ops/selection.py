"""The IPS selection loop with a running top-M buffer (counterpart of
ips_tpu/ops/selection.py).

  * shortcut when M >= N returns all patches, unshuffled
  * the index space (not the patch tensor) is padded so every chunk has
    I candidates; padded candidates are invalid
  * the buffer starts with the first M (post-permutation) patches
  * scoring adds the positional encoding, the buffer keeps the raw
    embeddings, and the kept set is gathered from the raw patches
  * ties go to the lower candidate position, as ``lax.top_k`` breaks them

Besides the per-chunk schedule, ``ips_select`` has the reference's two
variants, which select the same patches:

  * ``preencode``: encode all N patches first into a (B, N, D) table
    (in contiguous I-slices with ``preencode_chunked``, which bounds a conv
    encoder's activations to one slice), gather it once into permuted
    order, and slice each chunk's rows from it;
  * ``prepermute``: gather the patch tensor once into permuted order and
    encode contiguous chunk slices of it.

``ips_select_streaming_step`` is one iteration over a chunk the caller
brought to the device (the streaming selection of
``train/streaming.py``). ``encode_wrap`` places every selection encode:
exact context parallelism splits each chunk's patches over the ranks of
a patch group and gathers the embeddings back
(``parallel/ips_sharded.py``). The reference's ``unroll`` (a
``lax.scan`` unroll factor) has no meaning in an eager loop and is not
here.
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


def _select_step(score_fn: ScoreFn, mem_emb, mem_idx, mem_valid, cand_emb,
                 cand_idx, cand_valid, M: int,
                 pos_table: Optional[torch.Tensor]):
    """Merge I encoded candidates into the top-M buffer."""
    all_emb = torch.cat([mem_emb, cand_emb], dim=1)
    all_idx = torch.cat([mem_idx, cand_idx], dim=1)
    all_valid = torch.cat([mem_valid, cand_valid], dim=1)
    # score with positions added; the buffer keeps the raw embeddings
    emb_to_score = (all_emb + pos_table[all_idx]
                    if pos_table is not None else all_emb)
    return select_top_m(all_emb, emb_to_score, all_idx, all_valid, M,
                        score_fn)


def ips_select(encode_fn: EncodeFn, score_fn: ScoreFn,
               patches: torch.Tensor, *, M: int, I: int,
               pos_table: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               shuffle: bool = False, shuffle_style: str = "batch",
               return_emb: bool = False, prepermute: bool = False,
               preencode: bool = False,
               preencode_chunked: bool = False,
               encode_wrap: Optional[Callable[[EncodeFn, torch.Tensor],
                                              torch.Tensor]] = None
               ) -> SelectionResult:
    """Iterative Patch Selection over a resident patch tensor.

    Args:
      encode_fn: eval-mode encoder, (B, n, ...) -> (B, n, D) fp32.
      score_fn: scorer, ((B, L, D), (B, L) mask) -> (B, L).
      patches: (B, N, ...) patch tensor on the device.
      pos_table: optional (N, D) positional table (by original index).
      mask: optional (B, N) bool validity for variable-N data.
      generator, shuffle, shuffle_style: tie-break randomization.
      return_emb: also return the buffer's raw (B, M, D) embeddings.
      prepermute: gather the patches into permuted order once and encode
        contiguous slices (one extra (B, N, ...) copy on the device).
      preencode: encode all N patches up front and slice cached embedding
        rows per chunk (one extra (B, N, D) table on the device).
      preencode_chunked: build that table in contiguous I-slices, padded
        to a multiple of I, instead of one encode of all N.
      encode_wrap: optional (encode_fn, x) -> emb applied at every encode,
        the pre-encoded and pre-permuted ones included. Encoding is per
        patch, so it changes where patches are encoded, not what.
    """
    B, N = patches.shape[:2]
    if encode_wrap is not None:
        base_encode_fn = encode_fn

        def encode_fn(x):  # noqa: F811 - the wrapped encode
            return encode_wrap(base_encode_fn, x)

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

    patches_seq = _gather_rows(patches, perm) if prepermute else None
    emb_seq = None
    if preencode:
        if preencode_chunked and N > I:
            # contiguous I-slices of the zero-padded patches; encoding is
            # per patch, so the padding changes no embedding
            n_pad_enc = -(-N // I) * I - N
            p_pad = (torch.cat([patches, patches.new_zeros(
                (B, n_pad_enc) + patches.shape[2:])], dim=1)
                if n_pad_enc else patches)
            emb_table = torch.cat(
                [encode_fn(p_pad[:, s:s + I])
                 for s in range(0, N + n_pad_enc, I)], dim=1)[:, :N]
        else:
            emb_table = encode_fn(patches)
        emb_seq = _gather_rows(emb_table, perm)

    def chunk_emb(start: int, size: int) -> torch.Tensor:
        if emb_seq is not None:
            return emb_seq[:, start:start + size]
        if patches_seq is not None:
            return encode_fn(patches_seq[:, start:start + size])
        return encode_fn(_gather_rows(patches, perm[:, start:start + size]))

    mem_idx = perm[:, :M]
    mem_valid = perm_valid[:, :M]
    mem_emb = chunk_emb(0, M)
    for start in range(M, M + n_iter * I, I):
        mem_emb, mem_idx, mem_valid = _select_step(
            score_fn, mem_emb, mem_idx, mem_valid, chunk_emb(start, I),
            perm[:, start:start + I], perm_valid[:, start:start + I], M,
            pos_table)

    mem_patch = _gather_rows(patches, mem_idx)
    mem_pos = pos_table[mem_idx] if pos_table is not None else None
    return SelectionResult(mem_patch, mem_pos, mem_idx, mem_valid,
                           mem_emb if return_emb else None)


def ips_select_streaming_step(encode_fn: EncodeFn, score_fn: ScoreFn,
                              mem_emb: torch.Tensor, mem_idx: torch.Tensor,
                              mem_valid: torch.Tensor, chunk: torch.Tensor,
                              chunk_idx: torch.Tensor,
                              chunk_valid: torch.Tensor, M: int,
                              pos_table: Optional[torch.Tensor] = None):
    """One selection iteration over a chunk streamed from the host
    (the reference's lazy mode): encode it, merge it into the buffer.
    Returns the new (mem_emb, mem_idx, mem_valid)."""
    return _select_step(score_fn, mem_emb, mem_idx, mem_valid,
                        encode_fn(chunk), chunk_idx, chunk_valid, M,
                        pos_table)
