"""Device time of host-to-device copies in the traced window (profiler
records named Memcpy HtoD), per optimizer step (``h2d_ms.train``) or
request (``h2d_ms.serve``)."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.units:
        return None
    return 1e3 * tr.seconds_by(lambda n: "HtoD" in n) / tr.units
