"""Device time of the convolution kernels (cuDNN) in the traced window,
per optimizer step."""

from benchmark.trace import category


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    return 1e3 * tr.seconds_by(lambda n: category(n) == "convolution") \
        / tr.units
