"""Stream time of the train step's gradient re-encode: the milliseconds
between the CUDA events of the program's ``regrad`` spans (the gradient
forward of the kept patches and its backward) in the traced window, per
optimizer step. The card's idle inside the span, while it waits for the
host's launches, is counted too: it is not kernel time."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    return None if w is None else w.per_unit(w.device_ms("regrad"))
