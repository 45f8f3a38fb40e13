"""Model FLOP utilisation of the whole optimizer step (``mfu.train``) or
request (``mfu.serve``): the model FLOPs of the traced window's work
(benchmark/flops.py: selection encode of every valid patch, scoring, and
for training the forward and backward of the kept patches, recomputation
not counted) over the window's wall time and the card's bf16 dense peak,
in %. The window is profiled with CUDA activity only, so its wall is
about the unprofiled one (``benchmark/trace.py``)."""

from benchmark import peaks


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units or not rec.flops_per_unit:
        return None
    return 100.0 * rec.flops_per_unit * tr.units / tr.window_s \
        / peaks.MFU_PEAK
