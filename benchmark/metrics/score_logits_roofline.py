"""The saliency kernel's share of its roofline: the least time the card
could take for the scorer launches of the traced run's shapes pass over
their measured device time in that pass, in %. Each launch's bound is
the larger of its bytes (each input read once, each fp32 logit written
once) over the HBM rate and its operations over the peak of its input
type, from its logical (B, L, D) x (D, T*H) shape. Read as
``score_logits_roofline.train`` and ``score_logits_roofline.serve``."""

from benchmark import flops, peaks

_DTYPES = {"float": ("float32", 4), "c10::BFloat16": ("bfloat16", 2)}


def read(rec):
    tr = rec.trace
    if tr is None or not tr.score_launches or not tr.score_s:
        return None
    bound = 0.0
    for (B, L, D), (_, TH), dtype in tr.score_launches:
        name, size = _DTYPES[dtype]
        bound += max(flops.score_bytes(B, L, D, TH, size)
                     / peaks.HBM_BYTES_PER_S,
                     flops.score_flops(B, L, D, TH) / peaks.FLOPS[name])
    return 100.0 * bound / tr.score_s
