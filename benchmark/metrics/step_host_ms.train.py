"""Host time of a training step: the host milliseconds of the program's
``train.step`` spans less their ``data.next`` children (the loader and
the batch's preparation) in the traced window, per optimizer step."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    return None if w is None else w.per_unit(
        w.host_ms("train.step", minus="data.next"))
