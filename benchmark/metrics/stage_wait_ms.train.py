"""Device idle time while the host stages streamed chunks: the traced
window's device-idle milliseconds during which the program's innermost
span was ``select.stage`` (a stage's host gather into pinned memory and
the start of its copy), per optimizer step."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    if w is None or not w.named("select.stage"):
        return None
    return w.per_unit(w.idle_ms().get("select.stage", 0.0))
