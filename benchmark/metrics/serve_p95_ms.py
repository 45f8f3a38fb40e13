"""The 95th percentile of every request of the window, host to host
(numpy in, numpy out), in ms; linear interpolation between ranks."""

import numpy as np


def read(rec):
    if not rec.latencies_s or not rec.window_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s), 95) * 1e3)
