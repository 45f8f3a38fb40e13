"""Stream time of the optimizer's update: the milliseconds between the
CUDA events of the program's ``adamw`` spans (``opt.step()`` alone) in
the traced window, per optimizer step, the card's idle inside them
included."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    return None if w is None else w.per_unit(w.device_ms("adamw"))
