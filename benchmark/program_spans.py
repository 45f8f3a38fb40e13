"""The program's own spans in the traced window, on the device timeline.

The port records spans at its layer boundaries while a ``torch.profiler``
profile runs (``ips_tpu_torch.utils.profiling``: name, parent,
start and end on ``time.perf_counter_ns``, CUDA-event milliseconds for
the device-timed ones, counts). A traced run profiles its work twice
(``benchmark/trace.py``), so the recorder holds the spans of the window
pass, of any window pass that was taken again, and of the shapes pass.
``view`` reads the recorder once per record and keeps the window's:

1. it finds the pass whose top-level spans (``train.epoch`` or
   ``serve.request``) sit inside the benchmark's own spans of the window
   (``train_one_epoch`` or ``predict`` in ``rec.trace.spans``), one for
   one, once the first is put at the start of the first, none outside
   by more than ``TOL_NS``; of the passes that fit, the one whose spans
   end closest to the benchmark's is taken;
2. it moves that pass's spans onto the device timeline by the same
   shift (the program's call sits microseconds inside the benchmark's);
3. it checks them: no spans at all (the parent of this change), spans
   dropped by the recorder's bound, no pass that fits, or a window whose
   ``train.step`` / ``serve.request`` count differs from
   ``rec.trace.units`` give None to every reader.

The readers (``benchmark/metrics/``) get event milliseconds by span name,
host milliseconds, counts, and the device's idle time split among the
innermost program span the host was in.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

TOL_NS = 1_000_000

# (program's top-level span, the benchmark's span around it, the span
# counted against the trace's units)
TOPS = (("train.epoch", "train_one_epoch", "train.step"),
        ("serve.request", "predict", "serve.request"))


class Span(NamedTuple):
    """A program span in the window: ``parent`` indexes the window's
    spans (-1 at the top); times in ns on the device timeline."""
    name: str
    parent: int
    start: int
    end: int
    device_ms: Optional[float]
    counts: Dict[str, int]


def _take():
    """(spans, dropped) from the program's recorder; nothing where the
    program has none."""
    try:
        from ips_tpu_torch.utils.profiling import RECORDER
    except ImportError:
        return [], 0
    return RECORDER.take()


def _intervals_minus(a: int, b: int, cuts: List[Tuple[int, int]]
                     ) -> List[Tuple[int, int]]:
    """[a, b] without the sorted, disjoint intervals ``cuts``."""
    out, t = [], a
    for s, e in cuts:
        if s > t:
            out.append((t, min(s, b)))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return [(s, e) for s, e in out if e > s]


class Window:
    """The program's spans of the traced window."""

    def __init__(self, spans: List[Span], trace):
        self.spans, self.trace, self.units = spans, trace, trace.units

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def per_unit(self, total: Optional[float]) -> Optional[float]:
        return None if total is None else total / self.units

    def device_ms(self, name: str) -> Optional[float]:
        """Event milliseconds of the spans of ``name``; None if there are
        none or one has no device time."""
        got = [s.device_ms for s in self.named(name)]
        if not got or any(v is None for v in got):
            return None
        return sum(got)

    def host_ms(self, name: str, minus: str = "") -> Optional[float]:
        """Host milliseconds of the spans of ``name``, less those of
        their direct children named ``minus``."""
        idx = [i for i, s in enumerate(self.spans) if s.name == name]
        if not idx:
            return None
        inside = set(idx)
        less = sum(s.end - s.start for s in self.spans
                   if s.name == minus and s.parent in inside)
        return (sum(self.spans[i].end - self.spans[i].start for i in idx)
                - less) / 1e6

    def count(self, name: str, key: str) -> int:
        return sum(s.counts.get(key, 0) for s in self.named(name))

    def innermost(self) -> List[Tuple[int, int, str]]:
        """The window cut into (start, end, name) pieces by the innermost
        program span the host was in; pieces in no span are left out."""
        kids: Dict[int, List[Tuple[int, int]]] = {}
        for s in self.spans:
            kids.setdefault(s.parent, []).append((s.start, s.end))
        out = []
        for i, s in enumerate(self.spans):
            for a, b in _intervals_minus(s.start, s.end,
                                         sorted(kids.get(i, []))):
                out.append((a, b, s.name))
        return sorted(out)

    def idle_ms(self) -> Dict[str, float]:
        """Device-idle milliseconds of the window by the innermost
        program span the host was in."""
        a, b = self.trace.window
        idle = _intervals_minus(a, b, self.trace.busy_intervals())
        out: Dict[str, float] = {}
        pieces, j = self.innermost(), 0
        for s, e in idle:
            while j < len(pieces) and pieces[j][1] <= s:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0] < e:
                ps, pe, name = pieces[k]
                d = min(e, pe) - max(s, ps)
                if d > 0:
                    out[name] = out.get(name, 0.0) + d / 1e6
                k += 1
        return out


def _fit(tops, marks, shift) -> Optional[int]:
    """The largest distance of an aligned top-level span's end from its
    benchmark span's end; None where one falls outside its benchmark
    span by more than ``TOL_NS``."""
    worst = 0
    for t, (ms, me) in zip(tops, marks):
        s, e = t.start_ns + shift, t.end_ns + shift
        if s < ms - TOL_NS or e > me + TOL_NS:
            return None
        worst = max(worst, abs(me - e))
    return worst


def window(trace, raw, dropped: int = 0) -> Optional[Window]:
    """The window's spans out of the recorder's ``raw`` spans; None where
    the module docstring says."""
    if trace is None or not trace.units or dropped or not raw:
        return None
    for top, bench, unit in TOPS:
        marks = sorted((s, e) for n, s, e in trace.spans if n == bench)
        if marks:
            break
    else:
        return None
    tops = [s for s in raw if s.name == top and s.parent == -1
            and s.end_ns is not None]
    best = None
    for k in range(len(tops) - len(marks) + 1):
        shift = marks[0][0] - tops[k].start_ns
        worst = _fit(tops[k:k + len(marks)], marks, shift)
        if worst is not None and (best is None or worst < best[0]):
            best = (worst, shift)
    if best is None:
        return None
    shift = best[1]
    a, b = trace.window
    keep = [i for i, s in enumerate(raw) if s.end_ns is not None
            and a <= s.start_ns + shift <= b]
    new = {old: i for i, old in enumerate(keep)}
    spans = [Span(raw[i].name, new.get(raw[i].parent, -1),
                  raw[i].start_ns + shift, raw[i].end_ns + shift,
                  raw[i].device_ms, dict(raw[i].counts)) for i in keep]
    if sum(1 for s in spans if s.name == unit) != trace.units:
        return None
    return Window(spans, trace)


def view(rec) -> Optional[Window]:
    """The window's program spans of the record ``rec``: the recorder is
    read at the first call and the result kept on the record."""
    if "_program_window" not in vars(rec):
        raw, dropped = _take()
        rec._program_window = window(rec.trace, raw, dropped)
    return rec._program_window
