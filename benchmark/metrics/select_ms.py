"""Stream time of the program's selection: the milliseconds between the
CUDA events that open and close its ``select`` spans
(``IPSTrainer._select_impl``, ``StreamingSelector.select``) on the stream
its work runs on, in the traced window, per optimizer step
(``select_ms.train``) or request (``select_ms.serve``). It is not kernel
time: the card's idle inside the span is counted too, while it waits for
the host to launch the next kernel or, streamed, for a stage's copy
(``program_spans.Window.idle_ms`` splits that idle by span)."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    return None if w is None else w.per_unit(w.device_ms("select"))
