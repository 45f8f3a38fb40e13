"""Device time of the kernels of no other category (PyTorch's
elementwise passes: BatchNorm, ReLU, casts, adds) in the traced window,
per optimizer step (``elementwise_ms.train``) or request
(``elementwise_ms.serve``)."""

from benchmark.trace import ELEMENTWISE, category


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    return 1e3 * tr.seconds_by(lambda n: category(n) == ELEMENTWISE) \
        / tr.units
