"""Device timing on the card: CUDA events and the profiler's kernel times,
and the least time the card could take for a piece of work.

The timers need a CUDA device; a time from them is a device time.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# profiles device_ms takes of one function before it gives up
PROFILE_TRIES = 3


def bound_ms(nbytes: float, flops: float, dtype_name: str
             ) -> Tuple[float, str]:
    """Least time on the card in ms, and what sets it: ``nbytes`` (each
    input read once, each output written once) over the HBM rate, or
    ``flops`` over the peak rate of ``dtype_name``."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FLOPS[dtype_name]
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def cuda_ms(fn: Callable[[], object], iters: int = 200,
            warmup: int = 20) -> float:
    """Mean time of one call of ``fn`` in ms, from CUDA events around a run
    of ``iters`` back-to-back calls after ``warmup`` calls. Where one call
    enqueues less device work than the host takes to issue it, this is the
    host's issue rate, not the device's time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn: Callable[[], object], iters: int = 1
                   ) -> Dict[str, Tuple[float, int]]:
    """Run ``fn`` ``iters`` times under torch.profiler (CUPTI); returns
    {kernel name: (total device us, count)} over the device-side events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, Tuple[float, int]] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.device_time_total, n + 1)
    return out


def device_ms(fn: Callable[[], object], iters: int = 50,
              warmup: int = 20,
              rejected: Optional[List[Dict[str, int]]] = None
              ) -> Optional[float]:
    """Device time of one call of ``fn`` in ms: the summed durations of the
    kernels it launches (gaps between them excluded), from the profiler.
    Inputs stay in L2 where they fit.

    ``fn`` launches each of its kernels a fixed number of times a call,
    so in a whole profile of ``iters`` calls every kernel's count is a
    multiple of ``iters``. A profile where one is not has lost kernel
    records (on an H100, profiles late in a long process lost 18-19
    records each, 18 of 20 for one kernel), and its sum is not this
    function's time: it is taken again, up to ``PROFILE_TRIES`` times in
    all, and its counts ({kernel name: count}) are appended to
    ``rejected`` when that list is given. None if the profiler saw no
    device event, or no whole profile."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        kernels = device_kernels(fn, iters)
        if kernels and all(n % iters == 0 for _, n in kernels.values()):
            return sum(us for us, _ in kernels.values()) / iters / 1e3
        if rejected is not None:
            rejected.append({k: n for k, (_, n) in kernels.items()})
    return None
