"""Host time a training step waits on the program's loader: the
benchmark's span around each ``next()`` of the loader it hands
``train_one_epoch``, summed over the traced window, per optimizer step."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    return 1e3 * tr.span_seconds("loader_wait") / tr.units
