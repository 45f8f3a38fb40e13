"""The share of the patch slots that selection encoded which held a
valid patch: 100 times the ``valid`` counts over the ``slots`` counts of
the program's ``select`` spans in the traced window, in %. ``slots`` is
counted at each encode the selection makes, padding included; the rest
is padding (a slide padded to its bucket, a ragged last chunk)."""

from benchmark import program_spans


def read(rec):
    w = program_spans.view(rec)
    if w is None or not w.count("select", "slots"):
        return None
    return 100.0 * w.count("select", "valid") / w.count("select", "slots")
