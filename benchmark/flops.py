"""Operations and bytes worked out from shapes alone, for the benchmark's
utilisation and roofline metrics.

Model FLOPs count what the algorithm needs: two per multiply-add of the
convolutions and dense products; BatchNorm, activations, pooling and
softmax are left out as small. A training step counts the selection's
forward encode of every valid patch and its scoring, then the forward
and backward (three forwards) of the M kept patches per instance through
the encoder, the aggregator and the heads; recomputation kept to save
memory (a checkpointed re-encode) is not counted. A request counts the
selection and the aggregator's forward on the buffer's embeddings, which
are not encoded again.
"""

from __future__ import annotations

from typing import Iterable, Tuple

_STAGE_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet50": (3, 4, 6, 3)}


def _out(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def encoder_macs(enc_type: str, n_res_blocks: int, hw: Tuple[int, int],
                 c_in: int) -> int:
    """Multiply-adds of one patch through the truncated ResNet: the 7x7/2
    stem, the 3x3/2 max pool, then BasicBlocks (ResNet-18) or Bottlenecks
    (ResNet-50, stride on the 3x3), 1x1 downsampling where the shape
    changes."""
    h, w = _out(hw[0], 7, 2, 3), _out(hw[1], 7, 2, 3)
    macs = h * w * 49 * c_in * 64
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    c = 64
    bottleneck = enc_type == "resnet50"
    for s in range(2 if n_res_blocks == 2 else 4):
        width = 64 * 2 ** s
        for b in range(_STAGE_BLOCKS[enc_type][s]):
            stride = (1 if s == 0 else 2) if b == 0 else 1
            h2, w2 = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            if bottleneck:
                c_out = 4 * width
                macs += h * w * c * width                     # 1x1
                macs += h2 * w2 * 9 * width * width           # 3x3, stride
                macs += h2 * w2 * width * c_out               # 1x1
            else:
                c_out = width
                macs += h2 * w2 * 9 * c * width
                macs += h2 * w2 * 9 * width * width
            if c != c_out or stride != 1:
                macs += h2 * w2 * c * c_out                   # downsample
            h, w, c = h2, w2, c_out
    return macs


def patch_flops(conf: dict) -> int:
    """Forward FLOPs of encoding one patch."""
    return 2 * encoder_macs(conf["enc_type"], conf["n_res_blocks"],
                            tuple(conf["patch_size"]), conf["n_chan_in"])


def score_flops(rows: int, L: int, D: int, TH: int) -> int:
    """One saliency product (rows, L, D) x (D, T*H)."""
    return 2 * rows * L * D * TH


def score_bytes(rows: int, L: int, D: int, TH: int, itemsize: int) -> int:
    """Each input byte read once (x and W), each fp32 logit written once."""
    return itemsize * (rows * L * D + D * TH) + 4 * rows * L * TH


def merges(n: int, M: int, I: int) -> int:
    """Chunks of I merged into the buffer of M over n patches."""
    return 0 if M >= n else -(-(n - M) // I)


def aggregator_flops(conf: dict, rows: int, L: int) -> int:
    """Forward FLOPs of the cross-attention block, the MLP and the heads
    over (rows, L, D)."""
    D, H, T = conf["D"], conf["H"], conf["n_token"]
    dk, dv, di = conf["D_k"], conf["D_v"], conf["D_inner"]
    f = 2 * rows * L * D * H * (dk + dv)          # keys and values
    f += 2 * T * D * H * dk                       # queries
    f += 2 * rows * H * T * L * (dk + dv)         # logits, weighted sum
    f += 2 * rows * T * H * dv * D                # output projection
    f += 2 * rows * T * 2 * D * di                # MLP
    f += 2 * rows * D * conf["n_class"] * len(conf["tasks"])
    return f


def selection_flops(conf: dict, n_valid: Iterable[int], n_slots: int) -> int:
    """Selection over instances with ``n_valid`` real patches each, the
    walk covering ``n_slots`` patch slots (the padded N)."""
    rows = list(n_valid)
    M, I = conf["M"], conf["I"]
    L = M + I
    TH = conf["n_token"] * conf["H"]
    return (patch_flops(conf) * sum(rows)
            + merges(n_slots, M, I) * score_flops(len(rows), L, conf["D"],
                                                  TH))


def train_step_flops(conf: dict, n_valid: Iterable[int],
                     n_slots: int) -> int:
    """One optimizer step: selection of every instance, then forward and
    backward of the B x M kept patches and the aggregator."""
    rows = list(n_valid)
    B, M = len(rows), conf["M"]
    fwd = patch_flops(conf) * B * M + aggregator_flops(conf, B, M)
    return selection_flops(conf, rows, n_slots) + 3 * fwd


def request_flops(conf: dict, n_valid: Iterable[int], n_slots: int) -> int:
    """One served batch: selection, then the aggregator on the buffer."""
    rows = list(n_valid)
    return (selection_flops(conf, rows, n_slots)
            + aggregator_flops(conf, len(rows), conf["M"]))

