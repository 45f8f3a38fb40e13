"""Selection, training and evaluation steps (counterpart of
ips_tpu/train/steps.py).

:class:`IPSTrainer` owns the model, its AdamW optimizer and a step
counter, and runs each phase over that one set of parameters:

  * ``select``        — eval-mode IPS over a (B, N, ...) batch, no gradient
  * ``select_streaming`` — the same over a batch in host memory, chunks
                        streamed to the device (``eager: false``)
  * ``train_step``    — the gradient forward over the (B, M) memory batch
                        (batch statistics, dropout), then AdamW at the
                        given learning rate
  * ``eval_step``     — the same forward in eval mode, no gradient
  * ``fused_step``    — selection, then the train step on what it kept;
                        ``fused_multi_step`` runs K of them in order
  * ``fused_eval_step`` / ``fused_eval_multi_step`` — selection + eval
  * ``fused_sparse_*``  — the same from sparse pixels, densified on the
                        device inside each step (``conf.sparse_input``;
                        ``steps.py:284-296, 513-561, 622-654, 804-832``
                        there)
  * ``fused_assembled_*`` — B_seq < B: r loader batches, each selected with
                        its own generator, then one train or eval step
                        over their B = r * B_seq rows (``:656-800``)

As in the reference, ``train`` is passed to every module call: selection
sees running statistics and no dropout while the train forward of the
same step uses batch statistics and dropout, and the modules' own
``train()`` / ``eval()`` flags are never read. Shuffle and dropout draw
from the caller's ``torch.Generator`` (one per step, on the trainer's
device); they cannot reproduce ``jax.random``'s streams.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ips_tpu_torch.config import Config
from ips_tpu_torch.models.ips_net import DTYPES, IPSModel, init_weights
from ips_tpu_torch.models.quant import make_quant_encode_fn
from ips_tpu_torch.models.transformer import pos_enc_1d_np
from ips_tpu_torch.ops.densify import densify_patches
from ips_tpu_torch.ops.selection import ips_select
from ips_tpu_torch.utils.device import resolve_device
from ips_tpu_torch.utils.profiling import span

Tensors = Dict[str, torch.Tensor]


def compute_task_losses(conf: Config, preds: Tensors, labels: Tensors,
                        weights: torch.Tensor,
                        w_sum: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, Tensors]:
    """Per-task losses averaged into one scalar.

    softmax tasks: NLL of log(pred + eps); sigmoid tasks: BCE over the
    flattened outputs, clamped to [1e-7, 1 - 1e-7]. ``weights`` (B,)
    masks padded instances: weighted means over max(sum(w), 1). Under
    data parallelism ``w_sum`` is the global batch's sum(w), and the
    losses are this rank's shares of the global ones.
    """
    w_sum = torch.clamp(weights.sum() if w_sum is None else w_sum, min=1.0)
    task_losses = {}
    total = 0.0
    for task in conf.task_list:
        pred, label = preds[task.name], labels[task.name]
        if task.act_fn == "softmax":
            logp = torch.log(pred + conf.eps)                     # (B, C)
            nll = -torch.gather(logp, 1, label.long()[:, None])[:, 0]
            tl = (nll * weights).sum() / w_sum
        else:
            p = pred.reshape(pred.shape[0], -1)
            y = label.reshape(label.shape[0], -1).float()
            p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
            bce = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
            tl = (bce.mean(dim=-1) * weights).sum() / w_sum
        task_losses[task.name] = tl
        total = total + tl
    return total / len(conf.task_list), task_losses


@contextlib.contextmanager
def _running_stats_kept(module: nn.Module):
    """Leave ``module``'s buffers (its BatchNorm running statistics) as
    they were found. The backward's recompute of a checkpointed train-mode
    encode runs the forward again; the reference's ``jax.checkpoint`` is
    pure, and its new statistics come out of the forward once."""
    bufs = list(module.buffers())
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(bufs, saved):
                b.copy_(s)


def _detached(out):
    loss, task_losses, preds = out
    return (loss.detach(), {k: v.detach() for k, v in task_losses.items()},
            {k: v.detach() for k, v in preds.items()})


def _stacked(outs):
    """K per-step (loss, task_losses, preds) -> the same with a (K,) axis."""
    losses = torch.stack([o[0] for o in outs])
    task_losses = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
    preds = {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]}
    return losses, task_losses, preds


def _step_slice(k: int, patches, mask, labels, weights):
    return (patches[k], None if mask is None else mask[k],
            {n: v[k] for n, v in labels.items()}, weights[k])


def _cat_rows(outs):
    """Per-slot selection tuples -> each field concatenated over rows."""
    return tuple(None if xs[0] is None else torch.cat(xs)
                 for xs in zip(*outs))


class GradEncodeMemoryError(torch.cuda.OutOfMemoryError):
    """The gradient forward or backward of a train step, which re-encodes
    the B·M kept patches, ran out of device memory. Raised from PyTorch's
    error before any optimizer update. The step is never retried at
    another ``grad_encode_chunk``: each chunk takes its own batch
    statistics (ghost BatchNorm), so a chunked step trains another
    function than an unchunked one, and the choice stays the user's. This
    is the port's counterpart of XLA refusing the JAX package's step for
    its memory when it compiles it."""


_SIZE = r"([0-9.]+ [KMGT]?i?B)"


def _grad_memory_message(conf: Config, mem_patch: torch.Tensor,
                         error: BaseException) -> str:
    """What ``GradEncodeMemoryError`` says: the setting, what the step
    re-encodes, and the allocator's figures at the failure as PyTorch's
    error states them."""
    B, M = mem_patch.shape[:2]
    c = conf.grad_encode_chunk
    if c and c < M:
        what = (f"in slices of B·c = {B}·{c} = {B * c} of the "
                f"B·M = {B}·{M} = {B * M} kept patches")
    else:
        what = f"all B·M = {B}·{M} = {B * M} kept patches at once"
    text = str(error)
    asked = re.search(rf"Tried to allocate {_SIZE}", text)
    held = re.search(rf"Of the allocated memory {_SIZE} is allocated by "
                     rf"PyTorch, and {_SIZE} is reserved", text)
    total = re.search(rf"total capacity of {_SIZE}", text)
    figures = (f"held {held.group(1)} allocated ({held.group(2)} more "
               f"reserved) of the device's {total.group(1)} and asked for "
               f"{asked.group(1)} more" if asked and held and total
               else "figures are not stated")
    return (f"the train step's gradient re-encode ran out of device memory "
            f"at grad_encode_chunk={c}, re-encoding {what} with gradients: "
            f"the allocator {figures}. No update was applied. Set "
            f"grad_encode_chunk to a positive value below M = {M} (e.g. 32) "
            f"to bound the re-encode's memory; each slice then takes its own "
            f"batch statistics (ghost BatchNorm), so the step trains another "
            f"function than the unchunked one")


class IPSTrainer:
    """Owns the model, the optimizer and the step functions."""

    def __init__(self, conf: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None,
                 init_opt: bool = True):
        """Weights are drawn from ``generator`` (default: a CPU generator
        seeded with ``conf.seed``); with ``pretrained`` the image encoder
        then loads ``conf.pretrained_path``, an ``.npz`` converted by
        :mod:`ips_tpu_torch.models.pretrained`. Load trained weights with
        :mod:`ips_tpu_torch.weights` or ``model.load_state_dict``.
        ``init_opt=False`` skips the AdamW state, for inference."""
        self.conf = conf
        self.device = resolve_device(device)
        if conf.is_image and conf.pretrained and not conf.pretrained_path:
            raise ValueError(
                "pretrained=True requires pretrained_path: convert a local "
                "checkpoint with `python -m ips_tpu_torch.models.pretrained "
                "resnet.pth weights.npz` and set pretrained_path, or set "
                "pretrained=false")
        if generator is None:
            generator = torch.Generator().manual_seed(conf.seed)
        # module constructors draw their default init from the global
        # generator; keep the caller's global stream untouched
        with torch.random.fork_rng(devices=[]):
            self.model = IPSModel(conf)
        init_weights(self.model, generator)
        if conf.is_image and conf.pretrained:
            # the stem is rebuilt (kept at its initial values) when the
            # input is not 3-channel; every other mismatch, and every
            # encoder tensor the file does not hold, raises
            from ips_tpu_torch.models.pretrained import load_encoder_npz
            load_encoder_npz(conf.pretrained_path, self.model,
                             prefix="encoder/",
                             skip_keys=(("params/conv1/kernel",)
                                        if conf.n_chan_in != 3 else ()),
                             expect_cover=True)
        self.model.to(self.device)
        # AdamW with the reference's settings: betas (0.9, 0.999), eps 1e-8,
        # weight decay on every parameter; the lr is set before each step
        self.opt = (torch.optim.AdamW(self.model.parameters(), lr=0.0,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=conf.wd)
                    if init_opt else None)
        self.step = 0
        self.pos_table = (torch.from_numpy(pos_enc_1d_np(conf.D, conf.N))
                          .to(self.device) if conf.use_pos else None)
        self._streaming = None

    def new_generator(self, seed: int) -> torch.Generator:
        """A generator on the trainer's device, for one step's shuffle and
        dropout."""
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- selection ----------------------------------------------------------
    def _enc_score_fns(self):
        """(encode, score) closures for the selection pass (eval mode).

        With ``select_dtype: int8`` the encoder runs int8-quantized
        (models/quant.py): selection only ranks patches and its embeddings
        are discarded, and the train forward re-encodes the survivors in
        full precision.
        """
        if self.conf.select_dtype == "int8" and self.conf.is_image:
            return make_quant_encode_fn(self.model, self.conf), \
                self.model.scores
        return self.model.encode, self.model.scores

    def _resolve_preencode(self, shape: Sequence[int],
                           dtype: torch.dtype) -> bool:
        """``conf.preencode_select`` for a resident (B, N, ...) patch
        table of ``shape`` and ``dtype``: 'auto' pre-encodes once the table
        exceeds 96 MiB, unless M >= N (the shortcut encodes nothing per
        chunk). The threshold is the JAX package's, so that 'auto' picks
        the same selection schedule as the reference for every shape."""
        pe = self.conf.preencode_select
        if pe != "auto":
            return bool(pe)
        if self.conf.M >= shape[1]:
            return False
        table_bytes = math.prod(shape) * dtype.itemsize
        return table_bytes > 96 * 2**20

    def _selection_encode_wrap(self):
        """The placement of every selection encode (``ips_select``'s
        ``encode_wrap``): None, one device encodes everything."""
        return None

    def _stream_patch_split(self):
        """The streamed chunks' split over a patch group
        (``streaming.PatchSplit``): None, one device streams every
        patch."""
        return None

    def _slot_table_rows(self, local_rows: int) -> int:
        """The rows of the whole stacked (r * B_seq, N, ...) table whose
        ``local_rows`` this trainer holds: all of them on one device."""
        return local_rows

    def _select_impl(self, patches: torch.Tensor, mask: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     return_emb: bool = False,
                     preencode: Optional[bool] = None):
        """Eval-mode IPS over a (B, N, ...) patch tensor on the device.

        Returns (mem_patch, mem_pos, mem_idx, mem_mask), plus the buffer's
        raw (B, M, D) embeddings with ``return_emb=True``.
        ``preencode=None`` resolves ``conf.preencode_select`` on this
        tensor after its input cast; the assembled callers pass what the
        whole stacked table resolves to.
        """
        conf = self.conf
        with span("select", self.device) as sp:
            if (conf.input_dtype == "bfloat16"
                    and patches.dtype != torch.uint8):
                # one up-front cast halves the bytes of every chunk gather
                patches = patches.to(DTYPES[conf.input_dtype])
            if preencode is None:
                preencode = self._resolve_preencode(patches.shape,
                                                    patches.dtype)
            encode, score = self._enc_score_fns()
            res = ips_select(encode, score, patches, M=conf.M, I=conf.I,
                             pos_table=self.pos_table, mask=mask,
                             generator=generator, shuffle=conf.shuffle,
                             shuffle_style=conf.shuffle_style,
                             return_emb=return_emb, preencode=preencode,
                             # a conv encoder pre-encodes I patches at a
                             # time, which bounds its activations; the
                             # projector keeps the single encode
                             preencode_chunked=conf.is_image,
                             encode_wrap=self._selection_encode_wrap())
            B, N = patches.shape[:2]
            sp.set(slots=res.slots, valid=B * N if mask is None else mask)
        out = (res.mem_patch, res.mem_pos, res.mem_idx, res.mem_mask)
        return out + (res.mem_emb,) if return_emb else out

    @torch.no_grad()
    def select(self, patches: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Run IPS for one batch: (mem_patch, mem_pos, mem_idx, mem_mask)."""
        return self._select_impl(patches, mask, generator)

    @torch.no_grad()
    def select_streaming(self, patches: np.ndarray,
                         mask: Optional[np.ndarray] = None,
                         generator: Optional[torch.Generator] = None,
                         return_emb: bool = False):
        """IPS over a batch held in host memory (``eager: false``): chunks
        stream to the device, which holds O(M + I) patches. Returns what
        :meth:`select` returns on the device; with ``return_emb=True`` the
        patches are None and the buffer's (B, M, D) embeddings come fifth
        (see :class:`~ips_tpu_torch.train.streaming.StreamingSelector`)."""
        if self._streaming is None:
            from ips_tpu_torch.train.streaming import StreamingSelector
            self._streaming = StreamingSelector(self)
        return self._streaming.select(np.asarray(patches), mask, generator,
                                      return_emb=return_emb)

    # -- gradient step ------------------------------------------------------
    def _loss_and_aux(self, mem_patch, mem_pos, mem_mask, labels, weights,
                      generator):
        conf = self.conf
        attn_mask = mem_mask if conf.mask_padding else None
        if conf.grad_encode_chunk or conf.remat_encode:
            preds = self._grad_forward(mem_patch, mem_pos, attn_mask,
                                       weights, generator)
        else:
            preds = self.model(mem_patch, mem_pos, attn_mask, train=True,
                               weights=weights, generator=generator)
        loss, task_losses = self._task_losses(preds, labels, weights)
        return loss, task_losses, preds

    def _task_losses(self, preds, labels, weights):
        return compute_task_losses(self.conf, preds, labels, weights)

    def _reduce_grads(self) -> None:
        """Between the backward and the optimizer step: nothing on one
        device (the data-parallel trainer sums the gradients here)."""

    def _grad_forward(self, mem_patch, mem_pos, attn_mask, weights,
                      generator):
        """Gradient-mode forward with bounded encoder activation memory.

        The train-mode encode runs under ``torch.utils.checkpoint``: the
        backward recomputes it instead of keeping its activations across
        the transformer (exact). ``grad_encode_chunk=c`` encodes (B, c)
        slices of the M patches in order, a ``M % c`` tail as one smaller
        chunk, each with its own batch statistics (ghost BatchNorm), the
        running statistics updated chunk by chunk.
        """
        model, conf = self.model, self.conf

        def enc(x):
            return model.encode(x, train=True, weights=weights)

        def remat_enc(x):
            return checkpoint(enc, x, use_reentrant=False, context_fn=lambda: (
                contextlib.nullcontext(), _running_stats_kept(model.encoder)))

        M = mem_patch.shape[1]
        c = conf.grad_encode_chunk
        if c and c < M:
            tail = M % c
            embs = [remat_enc(mem_patch[:, s:s + c])
                    for s in range(0, M - tail, c)]
            if tail:
                embs.append(remat_enc(mem_patch[:, M - tail:]))
            emb = torch.cat(embs, dim=1)
        else:
            emb = remat_enc(mem_patch)
        if mem_pos is not None:
            emb = emb + mem_pos
        return model.predict(model.aggregate(emb, attn_mask, True, generator))

    def _train_impl(self, mem_patch, mem_pos, mem_mask, labels, weights,
                    generator, lr: float):
        self.opt.zero_grad(set_to_none=True)
        try:
            with span("regrad", self.device):
                out = self._loss_and_aux(mem_patch, mem_pos, mem_mask,
                                         labels, weights, generator)
                out[0].backward()
        except torch.cuda.OutOfMemoryError as e:
            self.opt.zero_grad(set_to_none=True)
            raise GradEncodeMemoryError(
                _grad_memory_message(self.conf, mem_patch, e)) from e
        self._reduce_grads()
        for group in self.opt.param_groups:
            group["lr"] = lr
        with span("adamw", self.device):
            self.opt.step()
        self.step += 1
        return _detached(out)

    def _require_opt(self):
        if self.opt is None:
            raise RuntimeError(
                "trainer was built with init_opt=False (inference-only); "
                "training steps need optimizer state")

    def train_step(self, mem_patch, mem_pos, mem_mask, labels, weights,
                   generator: Optional[torch.Generator], lr: float):
        """One AdamW step on a selected (B, M) memory batch; returns
        (loss, task_losses, preds). The gradients stay in ``.grad``. Every
        train step raises :class:`GradEncodeMemoryError` when its gradient
        pass runs out of device memory, before any update."""
        self._require_opt()
        return self._train_impl(mem_patch, mem_pos, mem_mask, labels,
                                weights, generator, lr)

    # -- eval ---------------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, mem_patch, mem_pos, mem_mask, labels, weights):
        attn_mask = mem_mask if self.conf.mask_padding else None
        preds = self.model(mem_patch, mem_pos, attn_mask, train=False)
        loss, task_losses = self._task_losses(preds, labels, weights)
        return loss, task_losses, preds

    def _reuse_eval_emb(self) -> bool:
        """Eval and inference may consume the selection buffer's
        embeddings: selection runs the encoder in the same eval mode the
        forward would, so re-encoding the M survivors recomputes the same
        values."""
        return self.conf.eval_reuse_emb and self.conf.select_dtype != "int8"

    @torch.no_grad()
    def eval_from_emb_step(self, mem_emb, mem_pos, mem_mask, labels,
                           weights):
        """Eval forward from the buffer's eval-mode embeddings: no patch
        gather, no encoder pass."""
        attn_mask = mem_mask if self.conf.mask_padding else None
        emb = mem_emb if mem_pos is None else mem_emb + mem_pos
        preds = self.model.predict(self.model.aggregate(emb, attn_mask))
        loss, task_losses = self._task_losses(preds, labels, weights)
        return loss, task_losses, preds

    @torch.no_grad()
    def fused_eval_step(self, patches, mask, labels, weights,
                        generator: Optional[torch.Generator] = None):
        """Selection + eval forward; returns (loss, task_losses, preds)."""
        if self._reuse_eval_emb():
            _, mem_pos, _, mem_mask, mem_emb = self._select_impl(
                patches, mask, generator, return_emb=True)
            return self.eval_from_emb_step(mem_emb, mem_pos, mem_mask,
                                           labels, weights)
        mem_patch, mem_pos, _, mem_mask = self._select_impl(patches, mask,
                                                            generator)
        return self.eval_step(mem_patch, mem_pos, mem_mask, labels, weights)

    def fused_eval_multi_step(
            self, patches, mask, labels, weights,
            generators: Optional[Sequence[torch.Generator]] = None):
        """K eval batches stacked on a leading (K,) axis; per-step outputs
        stacked the same way."""
        K = patches.shape[0]
        gens = generators if generators is not None else [None] * K
        return _stacked([
            self.fused_eval_step(*_step_slice(k, patches, mask, labels,
                                              weights), gens[k])
            for k in range(K)])

    # -- fused select + train -----------------------------------------------
    def _fused_impl(self, patches, mask, labels, weights, generator, lr):
        with span("train.step"):
            # selection sees the running statistics before this step's
            # update
            with torch.no_grad():
                mem_patch, mem_pos, _, mem_mask = self._select_impl(
                    patches, mask, generator)
            return self._train_impl(mem_patch, mem_pos, mem_mask, labels,
                                    weights, generator, lr)

    def fused_step(self, patches, mask, labels, weights,
                   generator: Optional[torch.Generator], lr: float):
        """Selection, then one AdamW step on what it kept."""
        self._require_opt()
        return self._fused_impl(patches, mask, labels, weights, generator,
                                lr)

    def fused_multi_step(self, patches, mask, labels, weights,
                         generators: Sequence[Optional[torch.Generator]],
                         lrs: Sequence[float]):
        """K fused steps in order (``conf.steps_per_dispatch``).

        patches / mask / labels / weights carry a leading (K,) step axis;
        ``generators`` and ``lrs`` hold one entry per step. The updates
        are those of K sequential ``fused_step`` calls; returns per-step
        (losses, task_losses, preds) stacked on a (K,) axis.
        """
        self._require_opt()
        return _stacked([
            self._fused_impl(*_step_slice(k, patches, mask, labels, weights),
                             generators[k], float(lrs[k]))
            for k in range(patches.shape[0])])

    # -- sparse input: densify on the device inside each step ---------------
    def densify(self, flat_idx, values, img_hw) -> torch.Tensor:
        """(B, nnz) sparse pixels (arrays or tensors) -> (B, N, ph, pw, C)
        patches on the trainer's device, in the input dtype."""
        conf = self.conf
        return densify_patches(torch.as_tensor(flat_idx, device=self.device),
                               torch.as_tensor(values, device=self.device),
                               tuple(img_hw), conf.patch_size,
                               n_chan=conf.n_chan_in,
                               out_dtype=DTYPES[conf.input_dtype])

    def _fused_sparse_impl(self, flat_idx, values, img_hw, mask, labels,
                           weights, generator, lr):
        with span("train.step"):
            # the dense batch is freed once selection has gathered what it
            # kept
            with torch.no_grad():
                mem_patch, mem_pos, _, mem_mask = self._select_impl(
                    self.densify(flat_idx, values, img_hw), mask, generator)
            return self._train_impl(mem_patch, mem_pos, mem_mask, labels,
                                    weights, generator, lr)

    def fused_sparse_step(self, flat_idx, values, img_hw, mask, labels,
                          weights, generator: Optional[torch.Generator],
                          lr: float):
        """Densify, select, one AdamW step (``conf.sparse_input``)."""
        self._require_opt()
        return self._fused_sparse_impl(flat_idx, values, img_hw, mask,
                                       labels, weights, generator, lr)

    def fused_sparse_multi_step(self, flat_idx, values, img_hw, mask, labels,
                                weights,
                                generators: Sequence[Optional[torch.Generator]],
                                lrs: Sequence[float]):
        """K sparse fused steps in order; a leading (K,) axis on every
        batch input. Each step densifies its own batch, so one step's dense
        batch is alive at a time."""
        self._require_opt()
        return _stacked([
            self._fused_sparse_impl(
                flat_idx[k], values[k], img_hw,
                *_step_slice(k, flat_idx, mask, labels, weights)[1:],
                generators[k], float(lrs[k]))
            for k in range(flat_idx.shape[0])])

    @torch.no_grad()
    def fused_sparse_eval_step(self, flat_idx, values, img_hw, mask, labels,
                               weights,
                               generator: Optional[torch.Generator] = None):
        """Densify, select, eval forward."""
        return self.fused_eval_step(self.densify(flat_idx, values, img_hw),
                                    mask, labels, weights, generator)

    def fused_sparse_eval_multi_step(
            self, flat_idx, values, img_hw, mask, labels, weights,
            generators: Optional[Sequence[torch.Generator]] = None):
        """K sparse eval batches on a leading (K,) axis."""
        K = flat_idx.shape[0]
        gens = generators if generators is not None else [None] * K
        return _stacked([
            self.fused_sparse_eval_step(
                flat_idx[k], values[k], img_hw,
                *_step_slice(k, flat_idx, mask, labels, weights)[1:],
                gens[k])
            for k in range(K)])

    # -- assembled: r loader batches -> one optimizer step (B_seq < B) -------
    def _select_slots(self, patches, mask, generators, return_emb=False):
        """r selections over (r, B_seq, N, ...), each with its own
        generator, concatenated into B = r * B_seq rows. ``preencode`` is
        resolved once, on the whole stacked table as it arrives (before
        the input cast): that is the tensor resident on the device, and
        under data ranks the global one (``_slots_preencode``)."""
        r = patches.shape[0]
        gens = generators if generators is not None else [None] * r
        pe = self._slots_preencode(patches.shape, patches.dtype)
        return _cat_rows([
            self._select_impl(patches[j], None if mask is None else mask[j],
                              gens[j], return_emb=return_emb, preencode=pe)
            for j in range(r)])

    def _slots_preencode(self, shape: Sequence[int],
                         dtype: torch.dtype) -> bool:
        """``preencode_select`` for stacked (r, B_seq, N, ...) slots of
        ``shape``: resolved on the whole (r * B_seq, N, ...) table."""
        rows = self._slot_table_rows(shape[0] * shape[1])
        return self._resolve_preencode((rows,) + tuple(shape[2:]), dtype)

    def _fused_assembled_impl(self, patches, mask, labels, weights,
                              sel_generators, train_generator, lr):
        with span("train.step"):
            with torch.no_grad():
                mem_patch, mem_pos, _, mem_mask = self._select_slots(
                    patches, mask, sel_generators)
            return self._train_impl(mem_patch, mem_pos, mem_mask, labels,
                                    weights, train_generator, lr)

    def fused_assembled_step(self, patches, mask, labels, weights,
                             sel_generators, train_generator, lr: float):
        """One optimizer step from r stacked loader batches: patches
        (r, B_seq, N, ...), mask (r, B_seq, N), labels / weights over the
        B = r * B_seq rows, one selection generator per loader batch."""
        self._require_opt()
        return self._fused_assembled_impl(patches, mask, labels, weights,
                                          sel_generators, train_generator,
                                          lr)

    def fused_assembled_multi_step(self, patches, mask, labels, weights,
                                   sel_generators, train_generators, lrs):
        """K assembled steps in order: patches (K, r, B_seq, N, ...),
        labels / weights (K, B, ...), K lists of r selection generators,
        K train generators, K lrs."""
        self._require_opt()
        return _stacked([
            self._fused_assembled_impl(
                *_step_slice(k, patches, mask, labels, weights),
                sel_generators[k], train_generators[k], float(lrs[k]))
            for k in range(patches.shape[0])])

    @torch.no_grad()
    def fused_assembled_eval_step(self, patches, mask, labels, weights,
                                  sel_generators=None):
        """One eval batch from r stacked loader batches (B_seq < B)."""
        if self._reuse_eval_emb():
            _, mem_pos, _, mem_mask, mem_emb = self._select_slots(
                patches, mask, sel_generators, return_emb=True)
            return self.eval_from_emb_step(mem_emb, mem_pos, mem_mask,
                                           labels, weights)
        mem_patch, mem_pos, _, mem_mask = self._select_slots(
            patches, mask, sel_generators)
        return self.eval_step(mem_patch, mem_pos, mem_mask, labels, weights)

    def fused_assembled_eval_multi_step(self, patches, mask, labels, weights,
                                        sel_generators=None):
        """K assembled eval batches on a leading (K,) axis."""
        K = patches.shape[0]
        gens = sel_generators if sel_generators is not None else [None] * K
        return _stacked([
            self.fused_assembled_eval_step(
                *_step_slice(k, patches, mask, labels, weights), gens[k])
            for k in range(K)])
