"""Efficiency tracking: per-step wall time + peak device memory
(counterpart of ips_tpu/utils/profiling.py), and the program's spans.

When ``conf.track_efficiency`` is on, each optimizer step is timed on the
host clock, bracketed by ``torch.cuda.synchronize`` on a CUDA device (the
host otherwise returns before the device has run the step), and at
``conf.track_epoch`` the mean step time and the peak allocated device
bytes are printed and the run stops.

Spans (``span``) mark the program's layer boundaries where the work runs:

  ``train.epoch``    ``loop.train_one_epoch``
  ``train.step``     one optimizer step, whatever the schedule: densify,
                     its selections, the re-encode and AdamW
  ``data.next``      the loop's ``next()`` on its loader and that batch's
                     preparation and upload
  ``select``         one selection (``IPSTrainer._select_impl``,
                     ``StreamingSelector.select``); device-timed; counts
                     ``slots`` (patch slots encoded, padding included)
                     and ``valid`` (valid patches among them)
  ``select.stage``   a streamed stage's host gather into pinned memory and
                     the start of its copy
  ``regrad``         the train step's gradient forward and backward;
                     device-timed
  ``adamw``          the optimizer's update; device-timed
  ``serve.request``  ``Predictor.predict``

They record only while a ``torch.profiler`` profile is running, into
``RECORDER``, which keeps them in memory until ``RECORDER.take()`` reads
them. Otherwise a span costs one test of the profiler's flag.
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


class Span(NamedTuple):
    """A recorded span: ``parent`` is the index of the span it opened
    inside (-1 at the top), the times are ``time.perf_counter_ns``, and
    ``device_ms`` is the time between its CUDA events on the stream its
    work ran on (None for a span that is not device-timed)."""
    name: str
    parent: int
    start_ns: int
    end_ns: Optional[int]
    device_ms: Optional[float]
    counts: Dict[str, int]


class _Open:
    """The handle of a span being recorded; ``set`` sets counts and
    ``add`` adds whole numbers to them. A count set may be an array or
    tensor, whose nonzero elements are counted; a tensor on the card is
    counted only when the spans are read, so that no device work runs
    inside the span."""
    __slots__ = ("rec", "index", "name", "parent", "start_ns", "end_ns",
                 "stream", "events", "counts", "range")

    def __init__(self, rec: "SpanRecorder", index: int, name: str,
                 parent: int, device: Optional[torch.device]):
        self.rec, self.index, self.name, self.parent = rec, index, name, parent
        self.counts: Dict[str, object] = {}
        self.end_ns: Optional[int] = None
        self.stream = self.events = None
        if device is not None and device.type == "cuda":
            self.stream = torch.cuda.current_stream(device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.range = None
        if rec.ranges:
            self.range = torch.profiler.record_function(name)
            self.range.__enter__()
        self.start_ns = time.perf_counter_ns()

    def set(self, **counts) -> None:
        for k, v in counts.items():
            on_card = isinstance(v, torch.Tensor) and v.device.type != "cpu"
            self.counts[k] = v if on_card else _count(v)

    def add(self, **counts: int) -> None:
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self) -> "_Open":
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record(self.stream)
        if self.range is not None:
            self.range.__exit__(*exc)
        stack = self.rec._stack
        if stack and stack[-1] is self:
            stack.pop()


class _Off:
    """The handle of a span that is not recorded."""
    __slots__ = ()

    def set(self, **counts) -> None:
        pass

    def add(self, **counts: int) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()


def _count(v) -> int:
    if isinstance(v, torch.Tensor):
        return int(torch.count_nonzero(v))
    if isinstance(v, np.ndarray):
        return int(np.count_nonzero(v))
    return int(v)


class SpanRecorder:
    """Spans in memory, at most ``limit`` until read; one more is dropped
    and counted in ``dropped``. Spans are opened by the thread that drives
    the steps. With ``ranges`` (``operator_ranges``) each span also opens
    a ``torch.profiler.record_function`` range of its name."""

    def __init__(self, limit: int = 1 << 16):
        self.limit = limit
        self.ranges = False
        self.dropped = 0
        self._spans: List[_Open] = []
        self._stack: List[_Open] = []

    def open(self, name: str, device: Optional[torch.device] = None,
             counts: Optional[dict] = None):
        if len(self._spans) >= self.limit:
            self.dropped += 1
            return _OFF
        parent = self._stack[-1].index if self._stack else -1
        s = _Open(self, len(self._spans), name, parent, device)
        s.set(**(counts or {}))
        self._spans.append(s)
        self._stack.append(s)
        return s

    def clear(self) -> None:
        """Drop what was recorded, unread."""
        self._spans, self._stack = [], []
        self.dropped = 0

    def take(self) -> Tuple[List[Span], int]:
        """The spans recorded since the last ``take``, in the order they
        opened, with their CUDA events resolved (this waits for them), and
        how many were dropped; the recorder is empty after it."""
        spans, dropped = self._spans, self.dropped
        self.clear()
        out = []
        for s in spans:
            ms = None
            if s.events is not None and s.end_ns is not None:
                s.events[1].synchronize()
                ms = s.events[0].elapsed_time(s.events[1])
            out.append(Span(s.name, s.parent, s.start_ns, s.end_ns, ms,
                            {k: _count(v) for k, v in s.counts.items()}))
        return out, dropped


RECORDER = SpanRecorder()


def span(name: str, device: Optional[torch.device] = None, **counts):
    """A context manager that records a span of ``name`` while a
    ``torch.profiler`` profile is running, and does nothing otherwise.
    ``device``: the work's device; on a CUDA device the span is
    device-timed by a CUDA event pair on its current stream, resolved
    only when the spans are read. It yields a handle whose ``set`` and
    ``add`` set and add counts."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return RECORDER.open(name, device, counts)


@contextlib.contextmanager
def operator_ranges():
    """Inside it each recorded span also opens a
    ``torch.profiler.record_function`` range of its name, so that an
    exported chrome trace shows the program's spans."""
    RECORDER.ranges = True
    try:
        yield
    finally:
        RECORDER.ranges = False
