"""The share of the traced window in which no kernel or copy ran on the
device: one minus the union of the device's intervals over the window's
wall, in %. The window is profiled with CUDA activity only, so the host
runs at about its unprofiled pace (``benchmark/trace.py``). Read as
``device_idle_share.train`` and ``device_idle_share.serve``."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
