"""Streaming (lazy) selection: the patches stay in host memory and chunks
stream to the device (counterpart of ips_tpu/train/streaming.py).

The reference's ``eager: false`` keeps the (B, N, ...) patch tensor on the
host and moves one I-chunk to the device per selection iteration. Here
the host walks the same permutation as the eager ``ips_select``, gathers
each chunk's rows (``native.gather_patches``, the ragged tail padded with
invalid slots), and the device runs ``ips_select_streaming_step`` on it.
The device holds the (B, M) buffer and one stage of chunks, O(M + I)
patches whatever N is; at the end the host gathers the M kept raw
patches and sends only those.

``stream_chunk_group`` = G chunks go to the device as one stage: one host
buffer and one copy for G chunks. Full groups come first, the remaining
``len(chunks) % G`` chunks go one at a time, so no padded chunk is ever
encoded and the chunk order, hence the selection, is that of G = 1.

On a card a stage is gathered into fresh pinned host memory and copied on
a stream of its own (``non_blocking``): the host gathers stage k+1 and its
copy runs while the card encodes stage k. The card waits for a stage's
copy (an event) before it encodes it; PyTorch's pinned-memory cache keeps
a buffer until its copy has finished, so a stage is never overwritten in
flight. Each stage is released before the next one is allocated, which
keeps one stage in the allocator's count whatever N is.

uint8 tiles stay uint8 to the encoder (which scales each chunk); other
input is cast to bfloat16 on the host when ``input_dtype`` asks for it.

Under a patch group (the trainer's ``_stream_patch_split``, exact
context parallelism) each rank stages, copies and encodes only its
contiguous n / n_cp slice of every chunk of n patches, and the (B, n, D)
embeddings are gathered back in patch order; a chunk's indices and
validity stay whole, so the selection step is unchanged. A count that
does not divide is staged and encoded whole. The M kept raw patches are
gathered whole.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ips_tpu_torch.models.ips_net import DTYPES
from ips_tpu_torch.native import gather_patches
from ips_tpu_torch.ops.selection import ips_select_streaming_step
from ips_tpu_torch.ops.shuffle import make_permutation
from ips_tpu_torch.utils.profiling import span

def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


_Staged = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                Optional[torch.cuda.Event]]


class PatchSplit(NamedTuple):
    """This rank's place in a patch group: ``gather`` concatenates every
    rank's (B, n / size, D) embeddings along dim 1 in patch order."""
    rank: int
    size: int
    gather: Callable[[torch.Tensor], torch.Tensor]


class StreamingSelector:
    """Streaming selection for an :class:`IPSTrainer`."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.conf = trainer.conf
        self.device = trainer.device
        self.group = max(int(self.conf.stream_chunk_group), 1)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self.split: Optional[PatchSplit] = trainer._stream_patch_split()

    def _part(self, n: int) -> slice:
        """This rank's patches of a chunk of ``n``: its contiguous slice
        under a patch group, all of them when ``n`` does not divide."""
        sp = self.split
        if sp is None or n % sp.size:
            return slice(0, n)
        k = n // sp.size
        return slice(sp.rank * k, (sp.rank + 1) * k)

    def _encoder(self, encode, n: int, sp):
        """The encode of a chunk of ``n`` patches staged by ``_part``: the
        slice's embeddings gathered back to all n. Each call adds the
        (B, n) patch slots it encoded to the ``slots`` of the ``select``
        span ``sp``."""
        part = self._part(n)
        whole = part.stop - part.start == n

        def counted(x):
            emb = encode(x) if whole else self.split.gather(encode(x))
            sp.add(slots=emb.shape[0] * emb.shape[1])
            return emb
        return counted

    def _host_tiles(self, patches: np.ndarray, idx: np.ndarray
                    ) -> torch.Tensor:
        """The rows idx (S, B, n) of patches as one (S, B, n, ...) host
        tensor, in pinned memory on a card and in the input dtype."""
        cast = (self.conf.input_dtype == "bfloat16"
                and patches.dtype != np.uint8)
        buf = torch.empty(idx.shape + patches.shape[2:],
                          dtype=(DTYPES["bfloat16"] if cast
                                 else _torch_dtype(patches.dtype)),
                          pin_memory=self._copy_stream is not None)
        for s in range(idx.shape[0]):
            if cast:
                buf[s].copy_(torch.from_numpy(gather_patches(patches,
                                                             idx[s])))
            else:
                gather_patches(patches, idx[s], out=buf[s].numpy())
        return buf

    def _stage(self, patches: np.ndarray, idx: np.ndarray,
               valid: np.ndarray, split: bool = True) -> _Staged:
        """Gather one stage on the host and start its copy to the device:
        (tiles, idx, valid), each with a leading (S,) chunk axis, and the
        event that marks the copy's end (None on the CPU). With ``split``
        the tiles are this rank's ``_part`` of each chunk; the indices and
        validity stay whole."""
        with span("select.stage"):
            part = self._part(idx.shape[-1]) if split else slice(None)
            tiles = self._host_tiles(patches, np.ascontiguousarray(
                idx[..., part]))
            idx, valid = torch.from_numpy(idx), torch.from_numpy(valid)
            if self._copy_stream is None:
                return (tiles, idx, valid), None
            host = (tiles, idx.pin_memory(), valid.pin_memory())
            with torch.cuda.stream(self._copy_stream):
                dev = tuple(t.to(self.device, non_blocking=True)
                            for t in host)
                done = torch.cuda.Event()
                done.record()
            return dev, done

    def _ready(self, staged: _Staged):
        """The staged tensors, usable on the current stream once their
        copy has ended."""
        tensors, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in tensors:
                # allocated on the copy stream, used on this one
                t.record_stream(cur)
        return tensors

    def _chunk_stages(self, n: int) -> List[List[int]]:
        """Chunk starts grouped into stages: full groups of G, then the
        rest one chunk at a time."""
        M, I, G = self.conf.M, self.conf.I, self.group
        starts = list(range(M, n, I))
        n_full = len(starts) // G * G if G > 1 else 0
        return ([starts[i:i + G] for i in range(0, n_full, G)]
                + [[s] for s in starts[n_full:]])

    def select(self, patches: np.ndarray, mask: Optional[np.ndarray] = None,
               generator: Optional[torch.Generator] = None,
               return_emb: bool = False) -> Sequence[Optional[torch.Tensor]]:
        """(mem_patch, mem_pos, mem_idx, mem_mask) on the device for a
        (B, N, ...) host batch. With ``return_emb=True``: (None, mem_pos,
        mem_idx, mem_mask, mem_emb), the buffer's raw (B, M, D)
        embeddings in place of a host gather, upload and re-encode of the
        kept patches; on the M >= N shortcut all N patches are encoded
        once for them."""
        B, N = patches.shape[:2]
        with span("select", self.device) as sp:
            sp.set(valid=B * N if mask is None else mask)
            return self._select(patches, mask, generator, return_emb, sp)

    def _select(self, patches: np.ndarray, mask: Optional[np.ndarray],
                generator: Optional[torch.Generator], return_emb: bool,
                sp):
        conf, tr, dev = self.conf, self.trainer, self.device
        M, I = conf.M, conf.I
        B, N = patches.shape[:2]
        mask_np = (np.ones((B, N), bool) if mask is None
                   else np.asarray(mask, bool))
        mask_d = torch.from_numpy(mask_np).to(dev)
        encode, score = tr._enc_score_fns()
        pos_table = tr.pos_table

        # the shortcut of the eager engine (reference ips_net.py:184-188):
        # every patch, unshuffled
        if M >= N:
            idx = torch.arange(N, device=dev).expand(B, N)
            pos = (pos_table[:N].expand(B, N, pos_table.shape[-1])
                   if pos_table is not None else None)
            (x,), _, _ = self._ready(self._stage(
                patches, np.tile(np.arange(N), (1, B, 1)), mask_np[None],
                split=return_emb))
            if return_emb:
                return None, pos, idx, mask_d, self._encoder(encode, N, sp)(x)
            return x, pos, idx, mask_d

        # the eager engine's permutation: valid patches first, the draws
        # from ``generator`` on the trainer's device
        perm = make_permutation(generator, B, N, mask_d, conf.shuffle,
                                conf.shuffle_style, dev).cpu().numpy()
        perm_valid = np.take_along_axis(mask_np, perm, axis=1)

        def host_stage(starts: Sequence[int], size: int):
            """(S, B, size) indices and validity of the chunks at
            ``starts``; a ragged tail is padded with invalid slots."""
            idx = np.zeros((len(starts), B, size), perm.dtype)
            valid = np.zeros((len(starts), B, size), bool)
            for s, start in enumerate(starts):
                n = min(size, N - start)
                idx[s, :, :n] = perm[:, start:start + n]
                valid[s, :, :n] = perm_valid[:, start:start + n]
            return patches, idx, valid

        # the buffer starts with the first M patches of the permutation
        tiles, mem_idx, mem_valid = self._ready(
            self._stage(*host_stage([0], M)))
        mem_emb = self._encoder(encode, M, sp)(tiles[0])
        mem_idx, mem_valid = mem_idx[0], mem_valid[0]
        del tiles
        encode_chunk = self._encoder(encode, I, sp)
        stages = self._chunk_stages(N)
        staged = self._stage(*host_stage(stages[0], I))
        for k in range(len(stages)):
            tiles, idx, valid = self._ready(staged)
            staged = None
            for j in range(tiles.shape[0]):
                mem_emb, mem_idx, mem_valid = ips_select_streaming_step(
                    encode_chunk, score, mem_emb, mem_idx, mem_valid,
                    tiles[j], idx[j], valid[j], M, pos_table)
            # this stage is released before the next one is allocated, and
            # the next one's copy runs while the card encodes the chunks
            # issued above
            del tiles, idx, valid
            if k + 1 < len(stages):
                staged = self._stage(*host_stage(stages[k + 1], I))

        mem_pos = pos_table[mem_idx] if pos_table is not None else None
        if return_emb:
            return None, mem_pos, mem_idx, mem_valid, mem_emb
        kept = mem_idx.cpu().numpy()[None]
        (mem_patch,), _, _ = self._ready(self._stage(
            patches, kept, np.ones(kept.shape, bool), split=False))
        return mem_patch, mem_pos, mem_idx, mem_valid
