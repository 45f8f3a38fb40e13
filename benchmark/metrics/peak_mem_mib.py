"""The device memory the window's work held at its peak:
``torch.cuda.max_memory_allocated`` over the window, reset at its start."""


def read(rec):
    return rec.peak_bytes / 2 ** 20 if rec.peak_bytes else None
