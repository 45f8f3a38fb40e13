"""The traced run: the cell's fixed piece of work three times, read into
device intervals, kernel categories, the saliency scorer's launches with
their shapes, and the benchmark's own host spans.

1. plain: the work without the profiler, timed on the host clock, so
   that the profiler's own cost shows beside its window (stderr);
2. window: the work under ``torch.profiler`` with CUDA activity only (no
   host op records, no shapes), which barely slows the host. Idle share,
   busy time, mfu and every per-kernel time read this pass. Its device
   timeline is tied to the host clock by a marker kernel launched right
   after a synchronisation, so the benchmark's host spans (recorded on
   the host clock) name its idle gaps;
3. shapes: a shorter piece of the same work with host op records and
   shapes, for the scorer's logical shapes and dtypes; the scorer's
   roofline reads this pass alone (bound and kernel time alike).

A profile can lose kernel records (on an H100 a profile late in a long
process lost 18 of 20 records of one kernel). The scorer's kernel is
launched once per counted call of the program's launch counter, so a
profile whose scorer records do not match that count is incomplete: it
is taken again, up to ``TRIES`` times in all, and never reported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

TRIES = 3
SCORE_OP = "ips_tpu_torch::score_logits"
SCORE_KERNEL_KEYS = ("score_logits", "logits_f32", "logits_bf16")

# kernel categories by name (first match wins)
_CATEGORIES = (
    ("score_logits kernel", SCORE_KERNEL_KEYS),
    ("scatter (densify, gather backward)", ("scatter",)),
    ("optimizer (AdamW)", ("multi_tensor", "adam")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "implicit")),
    ("gemm", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
    ("sort (top-M)", ("sort", "radix")),
    ("gather/index", ("gather", "index")),
    ("reduce (softmax, mean, pool)", ("reduce", "softmax", "pool", "mean")),
)
ELEMENTWISE = "elementwise/other"

# host spans (name, start ns, end ns on the host clock) while a window is
# being traced; None otherwise
_timeline: Optional[list] = None


def category(name: str) -> str:
    n = name.lower()
    for cat, keys in _CATEGORIES:
        if any(k in n for k in keys):
            return cat
    return ELEMENTWISE


def is_score_kernel(name: str) -> bool:
    return category(name) == "score_logits kernel"


@contextlib.contextmanager
def span(name: str, sink: Optional[list] = None):
    """A host span: with ``sink`` its host-clock seconds are appended
    there, and while a window is traced it joins the window's spans."""
    t0 = time.perf_counter_ns()
    yield
    t1 = time.perf_counter_ns()
    if sink is not None:
        sink.append((t1 - t0) / 1e9)
    if _timeline is not None:
        _timeline.append((name, t0, t1))


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]                       # ns, device timeline
    kernels: List[Tuple[str, int, int]]           # name, start, duration
    spans: List[Tuple[str, int, int]]             # name, start, end
    score_launches: List[Tuple[Tuple[int, ...], Tuple[int, ...], str]]
    units: int                                    # steps or requests
    score_s: float = 0.0          # scorer kernel time of the shapes pass
    plain_s: float = 0.0          # the window's work without the profiler

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of every device interval inside the window."""
        a, b = self.window
        iv = sorted((max(s, a), min(s + d, b)) for _, s, d in self.kernels
                    if s + d > a and s < b)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_by(self, pick: Callable[[str], bool]) -> float:
        return sum(d for n, _, d in self.kernels if pick(n)) / 1e9

    def span_seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def by_category(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n, _, d in self.kernels:
            c = category(n)
            out[c] = out.get(c, 0.0) + d / 1e9
        return out

    def _host_at(self, t: int) -> str:
        inner = [(e - s, n) for n, s, e in self.spans if s <= t <= e]
        return min(inner)[1] if inner else "outside"

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest device-idle gaps in the window, each named by the
        innermost host span around its middle."""
        a, b = self.window
        edges = [a] + [x for iv in self.busy_intervals() for x in iv] + [b]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[self._host_at(s + d // 2), d / 1e9] for d, s in gaps[:top]]

    def device_ops(self, top: int = 10) -> List[List]:
        """The categories and then the single kernels that took most
        device time, ``top`` entries in all."""
        cats = sorted(self.by_category().items(), key=lambda kv: -kv[1])
        names: Dict[str, float] = {}
        for n, _, d in self.kernels:
            names[n] = names.get(n, 0.0) + d / 1e9
        kern = sorted(names.items(), key=lambda kv: -kv[1])
        half = top // 2
        out = [[f"category {c}", s] for c, s in cats[:half]]
        out += [[f"kernel {n[:120]}", s] for n, s in kern[:top - len(out)]]
        return out


def _device_records(prof) -> List[Tuple[str, int, int]]:
    import torch
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _window_pass(work: Callable[[], int]):
    """(kernels, window, spans on the device timeline, units) of ``work``
    profiled with CUDA activity only; None without a marker record."""
    global _timeline
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    _timeline = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter_ns()
            torch.cuda._sleep(64)          # the marker: the window's start
            units = work()
            torch.cuda.synchronize()
            t1 = time.perf_counter_ns()
        spans = _timeline
    finally:
        _timeline = None
    kernels = _device_records(prof)
    if not kernels:
        return None
    # the device was idle at the marker's launch, so the first record is
    # the marker and starts within microseconds of t0
    anchor = min(s for _, s, _ in kernels)
    move = anchor - t0
    return (kernels, (anchor, anchor + t1 - t0),
            [(n, s + move, e + move) for n, s, e in spans], units)


def _shapes_pass(work: Callable[[], int]):
    """(scorer launches with shapes and dtypes, scorer kernel records) of
    ``work`` profiled with host op records and shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        work()
        torch.cuda.synchronize()
    launches, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if is_score_kernel(e.name()):
                kernels.append(e.duration_ns())
        elif e.name() == SCORE_OP:
            shapes = e.shapes()
            launches.append((tuple(shapes[0]), tuple(shapes[1]),
                             e.dtypes()[0]))
    return launches, kernels


def traced(work: Callable[[], int], shapes_work: Callable[[], int],
           launches: Callable[[], int], log: Callable[[str], None]
           ) -> Optional[Trace]:
    """The three passes (module docstring): ``work`` runs the window's
    fixed work and returns how many steps or requests it ran,
    ``shapes_work`` a shorter piece of it. None when no try gives a whole
    profile of either profiled pass."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    work()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    window = None
    for attempt in range(TRIES):
        before = launches()
        got = _window_pass(work)
        counted = launches() - before
        seen = -1 if got is None else sum(1 for n, _, _ in got[0]
                                          if is_score_kernel(n))
        if seen == counted:
            window = got
            break
        log(f"trace: refused a window profile with {seen} scorer kernel "
            f"records of {counted} launches (try {attempt + 1} of {TRIES})")
    if window is None:
        return None
    for attempt in range(TRIES):
        before = launches()
        shapes, score_ns = _shapes_pass(shapes_work)
        counted = launches() - before
        if len(shapes) == len(score_ns) == counted:
            break
        log(f"trace: refused a shapes profile with {len(score_ns)} scorer "
            f"kernel records and {len(shapes)} scorer ops of {counted} "
            f"launches (try {attempt + 1} of {TRIES})")
    else:
        return None
    kernels, span_ns, spans, units = window
    tr = Trace(span_ns, kernels, spans, shapes, units,
               score_s=sum(score_ns) / 1e9, plain_s=plain_s)
    log(f"trace: the window's work took {plain_s:.4f} s without the "
        f"profiler and {tr.window_s:.4f} s under it (CUDA activity only)")
    return tr
