"""Learning-rate schedule: per-step linear warmup then cosine decay
(copy of ips_tpu/train/schedule.py for the port).

  * steps are loader iterations, as the reference counts them
  * warmup: lr = max_lr * step / warmup_steps
  * cosine: lr = max_lr * q + 0.001 * max_lr * (1 - q),
    q = 0.5 (1 + cos(pi * s / S)) with s, S counted past warmup
"""

from __future__ import annotations

import math


def warmup_cosine_lr(step: int, steps_per_epoch: int, n_epoch: float,
                     n_epoch_warmup: float, max_lr: float) -> float:
    """Host-side schedule; the value is set on the optimizer per step."""
    max_steps = int(n_epoch * steps_per_epoch)
    warmup_steps = int(n_epoch_warmup * steps_per_epoch)
    if step < warmup_steps:
        return max_lr * step / max(warmup_steps, 1)
    step = step - warmup_steps
    max_steps = max(max_steps - warmup_steps, 1)
    q = 0.5 * (1.0 + math.cos(math.pi * step / max_steps))
    end_lr = max_lr * 0.001
    return max_lr * q + end_lr * (1.0 - q)
