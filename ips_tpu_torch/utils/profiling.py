"""Efficiency tracking: per-step wall time + peak device memory
(counterpart of ips_tpu/utils/profiling.py).

When ``conf.track_efficiency`` is on, each optimizer step is timed on the
host clock, bracketed by ``torch.cuda.synchronize`` on a CUDA device (the
host otherwise returns before the device has run the step), and at
``conf.track_epoch`` the mean step time and the peak allocated device
bytes are printed and the run stops.
"""

from __future__ import annotations

import sys
import time
from typing import List, Optional, Union

import numpy as np
import torch


def host_sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_peak_bytes(device: Union[str, torch.device]) -> Optional[int]:
    """Peak allocated bytes on a CUDA device since the last reset; None on
    the CPU, which keeps no such count."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device)


class EfficiencyTracker:
    def __init__(self, conf, device: Union[str, torch.device] = "cpu"):
        self.enabled = bool(conf.track_efficiency)
        self.track_epoch = conf.track_epoch
        self.device = torch.device(device)
        self.times: List[float] = []
        self._t0 = 0.0

    def start(self):
        if self.enabled:
            host_sync(self.device)
            self._t0 = time.perf_counter()

    def stop(self, epoch: int, data_it: int, is_last_batch: bool):
        """Record elapsed ms for one optimizer step."""
        if not self.enabled:
            return
        host_sync(self.device)
        elapsed_ms = (time.perf_counter() - self._t0) * 1000.0
        if epoch == self.track_epoch and data_it > 0 and not is_last_batch:
            self.times.append(elapsed_ms)
            print("time: ", elapsed_ms, flush=True)

    def finish_epoch(self, epoch: int):
        """Print the summary and end the run after the tracked epoch."""
        if not self.enabled or epoch != self.track_epoch:
            return
        print("avg. time: ", float(np.mean(self.times)) if self.times
              else float("nan"), flush=True)
        peak = device_peak_bytes(self.device)
        if peak is not None:
            print(f"Peak memory requirement: {peak / 1024 ** 3:.4f} GB",
                  flush=True)
        sys.exit(0)
