"""Device idle time in the training loop itself: the traced window's
device-idle milliseconds during which the host was in the program's
``train.epoch`` span and in no span beneath it (the loop's syncs and
bookkeeping between steps), per optimizer step."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    return None if w is None else w.per_unit(
        w.idle_ms().get("train.epoch", 0.0))
