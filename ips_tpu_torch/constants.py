"""Shared numeric constants (counterpart of ips_tpu/constants.py).

NEG_INF is the masked-logit fill value used by the selection loop, the
cross-attention scorer and the saliency kernel's epilogue. It stays
finite: a row whose candidates are all masked must give a uniform
softmax, not NaN, so it is never replaced by -inf.
"""

NEG_INF = -1e9
