"""Set-up: from the process's start to the window's start (traffic and
weights made, the program built and warmed, the first steps driven)."""


def read(rec):
    return rec.setup_s
