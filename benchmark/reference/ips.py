"""Plain reference of Iterative Patch Selection: inference, selection and
training steps, written from the published description (Bergner et al.,
ICLR 2023, arXiv:2210.13007) and the configuration files, in plain
PyTorch with float32 arithmetic and TF32 switched off.

It holds the truncated ResNet encoders (BasicBlock for ResNet-18,
Bottleneck for ResNet-50, torchvision's stride on the 3x3 conv) with a
row-weighted BatchNorm, the learnable-query cross-attention transformer
that both scores and aggregates patches, the task heads and losses, the
running top-M selection over chunks of I patches, and AdamW. Parameters
live in one dict under the flat reference names
(``params/encoder/conv1/kernel`` ...), conv kernels HWIO and dense
kernels (in, out), so the same arrays can be handed to any program.

``lowp=True`` computes every product (convolutions, dense layers, the
attention and scoring products) on operands rounded to fp8: e4m3 in the
forward and e5m2 for the gradients flowing back, each tensor scaled to
its format's range first. That is the benchmark's control: the step
below the bfloat16 that the configurations state.

Nothing here imports the system under test.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9          # masked logits stay finite: an all-masked row is uniform
BN_EPS = 1e-5
BN_MOMENTUM = 0.9       # running = m * running + (1 - m) * batch
LN_EPS = 1e-6
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

_STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}

Params = Dict[str, torch.Tensor]


def fp32_only() -> None:
    """Float32 products stay float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------- fp8
def _round_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to ``dtype`` after scaling its largest magnitude to the
    format's largest finite value, and scaled back."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _FakeFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


# ----------------------------------------------------------- structure
def _blocks(conf: dict) -> List[Tuple[str, int, int, int, bool]]:
    """(name, c_in, width, stride, downsample) of each residual block."""
    stages = 2 if conf["n_res_blocks"] == 2 else 4
    bottleneck = conf["enc_type"] == "resnet50"
    out, c_in = [], 64
    for s in range(stages):
        width = 64 * 2 ** s
        for b in range(_STAGE_BLOCKS[conf["enc_type"]][s]):
            stride = (1 if s == 0 else 2) if b == 0 else 1
            c_out = width * 4 if bottleneck else width
            out.append((f"layer{s + 1}_block{b}", c_in, width, stride,
                        c_in != c_out or stride != 1))
            c_in = c_out
    return out


def task_list(conf: dict) -> List[dict]:
    return sorted(conf["tasks"].values(), key=lambda t: t["id"])


def parameter_shapes(conf: dict) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of the model under its flat reference name, with its
    shape: ``params/...`` are trained, ``batch_stats/...`` are the
    BatchNorm running statistics."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def bn(path, c):
        shapes[f"params/{path}/scale"] = (c,)
        shapes[f"params/{path}/bias"] = (c,)
        shapes[f"batch_stats/{path}/mean"] = (c,)
        shapes[f"batch_stats/{path}/var"] = (c,)

    def conv(path, k, c_in, c_out):
        shapes[f"params/{path}/kernel"] = (k, k, c_in, c_out)

    def dense(path, d_in, d_out, bias):
        shapes[f"params/{path}/kernel"] = (d_in, d_out)
        if bias:
            shapes[f"params/{path}/bias"] = (d_out,)

    conv("encoder/conv1", 7, conf["n_chan_in"], 64)
    bn("encoder/bn1", 64)
    bottleneck = conf["enc_type"] == "resnet50"
    for name, c_in, w, _, ds in _blocks(conf):
        p = f"encoder/{name}"
        if bottleneck:
            conv(f"{p}/conv1", 1, c_in, w)
            bn(f"{p}/bn1", w)
            conv(f"{p}/conv2", 3, w, w)
            bn(f"{p}/bn2", w)
            conv(f"{p}/conv3", 1, w, 4 * w)
            bn(f"{p}/bn3", 4 * w)
            c_out = 4 * w
        else:
            conv(f"{p}/conv1", 3, c_in, w)
            bn(f"{p}/bn1", w)
            conv(f"{p}/conv2", 3, w, w)
            bn(f"{p}/bn2", w)
            c_out = w
        if ds:
            conv(f"{p}/downsample_conv", 1, c_in, c_out)
            bn(f"{p}/downsample_bn", c_out)
    D, H = conf["D"], conf["H"]
    shapes["params/transf/crs_attn/q"] = (1, conf["n_token"], D)
    dense("transf/crs_attn/q_w", D, H * conf["D_k"], False)
    dense("transf/crs_attn/k_w", D, H * conf["D_k"], False)
    dense("transf/crs_attn/v_w", D, H * conf["D_v"], False)
    dense("transf/crs_attn/fc", H * conf["D_v"], D, False)
    shapes["params/transf/crs_attn/layer_norm/scale"] = (D,)
    shapes["params/transf/crs_attn/layer_norm/bias"] = (D,)
    dense("transf/mlp/w_1", D, conf["D_inner"], True)
    dense("transf/mlp/w_2", conf["D_inner"], D, True)
    shapes["params/transf/mlp/layer_norm/scale"] = (D,)
    shapes["params/transf/mlp/layer_norm/bias"] = (D,)
    for t in task_list(conf):
        dense(f"head_{t['name']}", D, conf["n_class"], True)
    return shapes


def pos_table(D: int, n: int) -> np.ndarray:
    """Sin/cos positions (n, D): sin on even dims, cos on odd."""
    position = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, D, 2, dtype=np.float32)
                 * -(math.log(10000.0) / D))
    ang = position * div
    return np.stack([np.sin(ang), np.cos(ang)], -1).reshape(n, D).astype(
        np.float32)


def warmup_cosine_lr(step: int, steps_per_epoch: int, n_epoch: float,
                     n_epoch_warmup: float, max_lr: float) -> float:
    """Linear warm-up over loader steps, then cosine decay to a
    thousandth of the peak."""
    warm = int(n_epoch_warmup * steps_per_epoch)
    if step < warm:
        return max_lr * step / max(warm, 1)
    total = max(int(n_epoch * steps_per_epoch) - warm, 1)
    q = 0.5 * (1.0 + math.cos(math.pi * (step - warm) / total))
    return max_lr * q + max_lr * 0.001 * (1.0 - q)


# --------------------------------------------------------------- model
class RefIPS:
    """The IPS model over ``params`` (flat names, fp32 tensors on one
    device), which it updates in place when it trains."""

    def __init__(self, conf: dict, params: Params, lowp: bool = False):
        self.conf = conf
        self.P = params
        self.lowp = lowp
        self.tasks = task_list(conf)
        dev = next(iter(params.values())).device
        self.pos = (torch.from_numpy(pos_table(conf["D"], conf["N"])).to(dev)
                    if conf.get("use_pos") else None)
        self.adam: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.t = 0

    # -- arithmetic --------------------------------------------------------
    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return _FakeFp8.apply(t) if self.lowp else t

    def _conv(self, x, path, stride, pad):
        w = self.P[f"params/{path}/kernel"].permute(3, 2, 0, 1)
        return F.conv2d(self._q(x), self._q(w), stride=stride, padding=pad)

    def _dense(self, x, path):
        y = self._q(x) @ self._q(self.P[f"params/{path}/kernel"])
        b = self.P.get(f"params/{path}/bias")
        return y if b is None else y + b

    def _bn(self, x, path, train, row_w):
        scale = self.P[f"params/{path}/scale"].view(1, -1, 1, 1)
        bias = self.P[f"params/{path}/bias"].view(1, -1, 1, 1)
        rm = self.P[f"batch_stats/{path}/mean"]
        rv = self.P[f"batch_stats/{path}/var"]
        if not train:
            return ((x - rm.view(1, -1, 1, 1))
                    * torch.rsqrt(rv + BN_EPS).view(1, -1, 1, 1)
                    * scale + bias)
        w = (torch.ones(x.shape[0], device=x.device) if row_w is None
             else row_w).view(-1, 1, 1, 1)
        count = torch.clamp(w.sum() * x.shape[2] * x.shape[3], min=1.0)
        mean = (x * w).sum((0, 2, 3)) / count
        xc = x - mean.view(1, -1, 1, 1)
        var = (xc ** 2 * w).sum((0, 2, 3)) / count
        if self._update_stats:
            with torch.no_grad():
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                rm.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                rv.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * unbiased)
        return xc * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1) * scale + bias

    _update_stats = True

    # -- encoder -----------------------------------------------------------
    def encode(self, x: torch.Tensor, train: bool = False,
               row_w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(n, H, W, C) patches (uint8 tiles scale to [0, 1]) -> (n, D)."""
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        y = x.float().permute(0, 3, 1, 2)
        y = F.relu(self._bn(self._conv(y, "encoder/conv1", 2, 3),
                            "encoder/bn1", train, row_w))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        bottleneck = self.conf["enc_type"] == "resnet50"
        for name, _, _, stride, ds in _blocks(self.conf):
            p = f"encoder/{name}"
            if bottleneck:
                h = F.relu(self._bn(self._conv(y, f"{p}/conv1", 1, 0),
                                    f"{p}/bn1", train, row_w))
                h = F.relu(self._bn(self._conv(h, f"{p}/conv2", stride, 1),
                                    f"{p}/bn2", train, row_w))
                h = self._bn(self._conv(h, f"{p}/conv3", 1, 0), f"{p}/bn3",
                             train, row_w)
            else:
                h = F.relu(self._bn(self._conv(y, f"{p}/conv1", stride, 1),
                                    f"{p}/bn1", train, row_w))
                h = self._bn(self._conv(h, f"{p}/conv2", 1, 1), f"{p}/bn2",
                             train, row_w)
            res = (self._bn(self._conv(y, f"{p}/downsample_conv", stride, 0),
                            f"{p}/downsample_bn", train, row_w) if ds else y)
            y = F.relu(h + res)
        return y.mean(dim=(2, 3))

    def encode_rows(self, x: torch.Tensor, train: bool = False,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n, H, W, C) -> (B, n, D); ``weights`` (B,) weigh each
        instance's rows in the batch statistics of training."""
        B, n = x.shape[:2]
        row_w = None if weights is None else weights.repeat_interleave(n)
        return self.encode(x.reshape((B * n,) + x.shape[2:]), train,
                           row_w).reshape(B, n, -1)

    # -- transformer -------------------------------------------------------
    def _layer_norm(self, x, path):
        return F.layer_norm(x, x.shape[-1:], self.P[f"params/{path}/scale"],
                            self.P[f"params/{path}/bias"], LN_EPS)

    def _heads(self, x, d):
        B, L = x.shape[:2]
        return x.reshape(B, L, self.conf["H"], d).transpose(1, 2)

    def attention(self, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention weights (B, H, T, L) of the query tokens over x."""
        c = self.conf
        q = self._heads(self._dense(self.P["params/transf/crs_attn/q"],
                                    "transf/crs_attn/q_w"), c["D_k"])
        k = self._heads(self._dense(x, "transf/crs_attn/k_w"), c["D_k"])
        logits = torch.einsum("xhtd,bhld->bhtl", self._q(q),
                              self._q(k)) / math.sqrt(c["D_k"])
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], NEG_INF)
        return torch.softmax(logits, dim=-1)

    def scores(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Saliency (B, L): the attention averaged over heads and tokens."""
        return self.attention(x, mask).mean(dim=(1, 2))

    @staticmethod
    def _dropout(x, p, gen):
        if gen is None or p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen,
                          device=gen.device).to(x.device) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))

    def aggregate(self, x: torch.Tensor,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, D) -> (B, T, D); dropout draws from ``gen`` when given
        (training), in the order attention, output projection, MLP."""
        c = self.conf
        B = x.shape[0]
        attn = self._dropout(self.attention(x), c["attn_dropout"], gen)
        v = self._heads(self._dense(x, "transf/crs_attn/v_w"), c["D_v"])
        out = torch.einsum("bhtl,bhld->bhtd", self._q(attn), self._q(v))
        out = out.transpose(1, 2).reshape(B, c["n_token"], -1)
        out = self._dropout(self._dense(out, "transf/crs_attn/fc"),
                            c["dropout"], gen)
        z = self._layer_norm(out + self.P["params/transf/crs_attn/q"],
                             "transf/crs_attn/layer_norm")
        h = F.relu(self._dense(z, "transf/mlp/w_1"))
        h = self._dropout(self._dense(h, "transf/mlp/w_2"), c["dropout"], gen)
        return self._layer_norm(h + z, "transf/mlp/layer_norm")

    def predict(self, agg: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for t in self.tasks:
            logit = self._dense(agg[:, t["id"]], f"head_{t['name']}")
            out[t["name"]] = (torch.softmax(logit, -1)
                              if t["act_fn"] == "softmax"
                              else torch.sigmoid(logit))
        return out

    def losses(self, preds, labels, weights) -> Tuple[torch.Tensor, dict]:
        """Mean over tasks of the instance-weighted task losses: NLL of
        log(p + eps) for softmax tasks, clamped BCE for sigmoid ones."""
        w_sum = torch.clamp(weights.sum(), min=1.0)
        per_task = {}
        for t in self.tasks:
            p, y = preds[t["name"]], labels[t["name"]]
            if t["act_fn"] == "softmax":
                logp = torch.log(p + self.conf["eps"])
                nll = -logp.gather(1, y.long()[:, None])[:, 0]
                per_task[t["name"]] = (nll * weights).sum() / w_sum
            else:
                p = torch.clamp(p.reshape(p.shape[0], -1), 1e-7, 1 - 1e-7)
                y = y.reshape(y.shape[0], -1).float()
                bce = -(y * torch.log(p) + (1 - y) * torch.log1p(-p))
                per_task[t["name"]] = (bce.mean(-1) * weights).sum() / w_sum
        return sum(per_task.values()) / len(self.tasks), per_task

    # -- selection ---------------------------------------------------------
    def select(self, patches: torch.Tensor, perm: torch.Tensor,
               valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Running top-M over (B, N, ...) ``patches`` walked in the order
        ``perm`` (B, N), eval mode, no gradient: the first M patches fill
        the buffer, then each chunk of I candidates is scored together
        with the buffer and the best M stay; ties keep the earlier
        candidate. ``valid`` (B, N) marks real patches by original index.
        Returns the kept (B, M) indices and their validity."""
        M, I = self.conf["M"], self.conf["I"]
        B, N = perm.shape
        rows = torch.arange(B, device=perm.device)[:, None]
        pvalid = valid[rows, perm]
        if M >= N:
            return perm, pvalid
        n_iter = -(-(N - M) // I)
        pad = M + n_iter * I - N
        perm = torch.cat([perm, perm.new_zeros((B, pad))], 1)
        pvalid = torch.cat([pvalid, pvalid.new_zeros((B, pad))], 1)
        with torch.no_grad():
            idx, ok = perm[:, :M], pvalid[:, :M]
            emb = self.encode_rows(patches[rows, idx])
            for s in range(M, M + n_iter * I, I):
                c_idx, c_ok = perm[:, s:s + I], pvalid[:, s:s + I]
                emb = torch.cat([emb, self.encode_rows(patches[rows, c_idx])],
                                1)
                idx = torch.cat([idx, c_idx], 1)
                ok = torch.cat([ok, c_ok], 1)
                sc = self.scores(self._scored(emb, idx), ok)
                sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
                val, top = torch.sort(sc, dim=1, descending=True, stable=True)
                top = top[:, :M]
                emb, idx = emb[rows, top], idx[rows, top]
                ok = val[:, :M] > 0.5 * NEG_INF
        return idx, ok

    def saliency(self, patches: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        """Eval-mode saliency (B, N) of every patch of each row, all valid
        patches scored together, encoded in chunks of I; 0 where a patch
        is not valid."""
        B, N = valid.shape
        I = self.conf["I"]
        idx = torch.arange(N, device=valid.device).expand(B, N)
        with torch.no_grad():
            emb = torch.cat([self.encode_rows(patches[:, s:s + I])
                             for s in range(0, N, I)], 1)
            sc = self.scores(self._scored(emb, idx), valid)
        return torch.where(valid, sc, torch.zeros_like(sc))

    def _scored(self, emb, idx):
        return emb if self.pos is None else emb + self.pos[idx]

    def set_scores(self, patches: torch.Tensor, idx: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        """Eval-mode saliency of the candidate set ``idx`` (B, L) of each
        row, scored together (the measure selection ranks by)."""
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        with torch.no_grad():
            emb = self.encode_rows(patches[rows, idx])
            return self.scores(self._scored(emb, idx), valid)

    # -- forward and training ---------------------------------------------
    def forward_eval(self, patches, idx) -> Dict[str, torch.Tensor]:
        """Eval-mode predictions from the kept patches ``idx`` (B, M)."""
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        with torch.no_grad():
            emb = self._scored(self.encode_rows(patches[rows, idx]), idx)
            return self.predict(self.aggregate(emb))

    def train_step(self, mem_patch: torch.Tensor, mem_idx: torch.Tensor,
                   labels: Dict[str, torch.Tensor], weights: torch.Tensor,
                   gen: Optional[torch.Generator], lr: float,
                   chunk: int = 0):
        """One AdamW step on the kept (B, M, ...) patches. The train-mode
        encode takes batch statistics over slices of ``chunk`` patches of
        every instance (the whole M when 0), slice by slice, each slice
        updating the running statistics once. Returns (loss, task
        losses, predictions, gradients), all detached."""
        B, M = mem_patch.shape[:2]
        c = chunk if chunk and chunk < M else M
        slices = [(s, min(s + c, M)) for s in range(0, M, c)]
        trained = {k: v for k, v in self.P.items() if k.startswith("params/")}
        # the slices' embeddings once, with the running statistics moving
        with torch.no_grad():
            emb = torch.cat([self.encode_rows(mem_patch[:, a:b], True,
                                              weights) for a, b in slices], 1)
        emb.requires_grad_(True)
        for v in trained.values():
            v.requires_grad_(True)
        preds = self.predict(self.aggregate(self._scored(emb, mem_idx), gen))
        loss, per_task = self.losses(preds, labels, weights)
        names = list(trained)
        grads = torch.autograd.grad(loss, [emb] + [trained[k] for k in names],
                                    allow_unused=True)
        g_emb = grads[0]
        total = {k: (g if g is not None else torch.zeros_like(trained[k]))
                 for k, g in zip(names, grads[1:])}
        # each slice again with gradients, fed the embeddings' gradient
        self._update_stats = False
        try:
            for a, b in slices:
                e = self.encode_rows(mem_patch[:, a:b], True, weights)
                enc = [k for k in names if k.startswith("params/encoder/")]
                gs = torch.autograd.grad(e, [trained[k] for k in enc],
                                         g_emb[:, a:b], allow_unused=True)
                for k, g in zip(enc, gs):
                    if g is not None:
                        total[k] = total[k] + g
        finally:
            self._update_stats = True
        for v in trained.values():
            v.requires_grad_(False)
        self.adamw(total, lr)
        return (loss.detach(), {k: v.detach() for k, v in per_task.items()},
                {k: v.detach() for k, v in preds.items()}, total)

    def adamw(self, grads: Params, lr: float) -> None:
        """torch.optim.AdamW's update: decoupled decay on every trained
        leaf, bias-corrected moments."""
        b1, b2 = ADAM_BETAS
        wd = self.conf["wd"]
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                p = self.P[k]
                m, v = self.adam.get(k, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                self.adam[k] = (m, v)
                p.mul_(1 - lr * wd)
                p.sub_((lr / bc1) * m / (v.sqrt() / math.sqrt(bc2) + ADAM_EPS))


def permutation(gen: Optional[torch.Generator], B: int, N: int,
                valid: torch.Tensor, shuffle: bool) -> torch.Tensor:
    """The order selection walks: one uniform draw of N shared by the
    batch from ``gen``, real patches first; without shuffle real patches
    first in index order."""
    if not shuffle:
        return torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    u = torch.rand((1, N), generator=gen, device=gen.device).expand(B, N)
    u = u.to(valid.device)
    return torch.argsort(torch.where(valid, u, u + 2.0), dim=1)


def fold_seed(seed: int, data: int) -> int:
    """splitmix64 of (seed, data), cut to 63 bits: the seed of the
    generator of loader step ``data`` in an epoch seeded ``seed``."""
    m = (1 << 64) - 1
    z = (seed * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return (z ^ (z >> 31)) >> 1


def train_base_seed(seed: int, epoch: int) -> int:
    return seed * 1_000_003 + epoch
