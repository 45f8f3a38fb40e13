"""Valid patches that the window's optimizer steps selected over, over
the window's wall time: whole steps only, all the work and all the
time."""


def read(rec):
    if not rec.window_s or not rec.steps:
        return None
    return rec.patches / rec.window_s
