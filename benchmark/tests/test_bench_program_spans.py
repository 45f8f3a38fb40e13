"""``benchmark/program_spans.py`` and its readers on a made-up trace and
made-up program spans: the alignment, the pass it picks, the split of
the device's idle time among innermost spans, each reader against a hand
count, and None where the window cannot be trusted."""

import pytest

from benchmark import core, program_spans
from benchmark.trace import Trace
from ips_tpu_torch.utils.profiling import Span

MS = 1_000_000
RAW = 7_000_000_000_000     # the program's clock, far from the device's

# the window's program spans on the device timeline, in ms: (name, parent,
# start, end, event ms, counts)
TRAIN = [
    ("train.epoch", -1, 1, 18.99, None, {}),
    ("data.next", 0, 1.5, 3.5, None, {}),
    ("train.step", 0, 4, 10, None, {}),
    ("select", 2, 4.5, 7, 2.0, {"slots": 100, "valid": 80}),
    ("select.stage", 3, 4.6, 5, None, {"bytes": 10}),
    ("regrad", 2, 7, 9, 1.5, {}),
    ("adamw", 2, 9, 9.5, 0.25, {}),
    ("data.next", 0, 10.5, 11, None, {}),
    ("train.step", 0, 11, 18, None, {}),
    ("select", 8, 11, 14, 2.5, {"slots": 100, "valid": 70}),
    ("select.stage", 9, 11.2, 12, None, {"bytes": 10}),
    ("data.next", 8, 14, 15, None, {}),
    ("regrad", 8, 15, 17, 1.75, {}),
    ("adamw", 8, 17, 17.5, 0.25, {}),
]
# busy [0, 1], [5, 6], [7, 9.5], [12, 14], [15.5, 17.5] of a 20 ms window
KERNELS = [("marker", 0, 1), ("k", 5, 1), ("k", 7, 2.5), ("k", 12, 2),
           ("k", 15.5, 2)]


def _raw(spans, at, events=True):
    """Recorder spans at host-clock ``at`` (ms) after RAW."""
    return [Span(n, p, int(RAW + (at + s) * MS), int(RAW + (at + e) * MS),
                 d if events else None, dict(c))
            for n, p, s, e, d, c in spans]


def _trace(units=2, bench=(("train_one_epoch", 1, 19),
                           ("loader_wait", 2, 3))):
    return Trace((0, 20 * MS),
                 [(n, int(s * MS), int(d * MS)) for n, s, d in KERNELS],
                 [(n, int(s * MS), int(e * MS)) for n, s, e in bench],
                 [], units)


def _record(trace, raw, monkeypatch, dropped=0):
    monkeypatch.setattr(program_spans, "_take", lambda: (raw, dropped))
    return core.Record("mnist.train", {}, {}, trace=trace, steps=2)


def _read(rec, *names):
    return {n: core.metric_reader(n)(rec) for n in names}


TRAIN_METRICS = ("select_ms.train", "regrad_ms.train", "adamw_ms.train",
                 "step_host_ms.train", "stage_wait_ms.train",
                 "loop_idle_ms.train", "select_valid_share.train")


def test_alignment_puts_the_first_epoch_at_the_benchmark_span(monkeypatch):
    rec = _record(_trace(), _raw(TRAIN, 1000), monkeypatch)
    w = program_spans.view(rec)
    assert [s.start for s in w.spans] == [int(s * MS) for _, _, s, _, _, _
                                          in TRAIN]
    assert [s.parent for s in w.spans] == [p for _, p, *_ in TRAIN]
    # read once per record
    monkeypatch.setattr(program_spans, "_take", lambda: 1 / 0)
    assert program_spans.view(rec) is w


def test_idle_split_among_innermost_spans(monkeypatch):
    w = program_spans.view(_record(_trace(), _raw(TRAIN, 1000),
                                   monkeypatch))
    # idle [1, 5], [6, 7], [9.5, 12], [14, 15.5], [17.5, 20] cut by the
    # innermost span; [18.99, 20] is in no program span
    want = {"train.epoch": 0.5 + 0.5 + 0.5 + 0.99,
            "data.next": 2 + 0.5 + 1, "train.step": 0.5 + 0.5 + 0.5,
            "select": 0.1 + 1 + 0.2, "select.stage": 0.4 + 0.8,
            "regrad": 0.5}
    got = w.idle_ms()
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k]), k


def test_readers_against_hand_counts(monkeypatch):
    rec = _record(_trace(), _raw(TRAIN, 1000), monkeypatch)
    got = _read(rec, *TRAIN_METRICS)
    want = {"select_ms.train": (2.0 + 2.5) / 2,
            "regrad_ms.train": (1.5 + 1.75) / 2,
            "adamw_ms.train": 0.25,
            # 6 + 7 ms of steps less the second step's 1 ms data.next
            "step_host_ms.train": (6 + 7 - 1) / 2,
            "stage_wait_ms.train": (0.4 + 0.8) / 2,
            "loop_idle_ms.train": (0.5 + 0.5 + 0.5 + 0.99) / 2,
            "select_valid_share.train": 100 * 150 / 200}
    for k in want:
        assert got[k] == pytest.approx(want[k]), k


def test_the_best_fitting_pass_is_taken(monkeypatch):
    # a window pass taken before (its profile refused), whose epoch ends
    # 0.5 ms earlier, and the shapes pass after: one epoch of one step
    refused = [(n, p, s, e - 0.5 if n == "train.epoch" else e, 9.0, c)
               for n, p, s, e, _, c in TRAIN]
    shapes = [("train.epoch", -1, 1, 8, None, {}),
              ("train.step", 0, 2, 7, None, {}),
              ("select", 1, 2, 4, 7.0, {"slots": 1, "valid": 1})]
    raw = _raw(refused, 0) + _raw(TRAIN, 1000) + _raw(shapes, 2000)
    got = _read(_record(_trace(), raw, monkeypatch), "select_ms.train",
                "select_valid_share.train")
    assert got["select_ms.train"] == pytest.approx(2.25)
    assert got["select_valid_share.train"] == pytest.approx(75.0)


def test_serving_reads_per_request(monkeypatch):
    serve = [("serve.request", -1, 1, 4, None, {}),
             ("select", 0, 1.5, 3, 1.0, {"slots": 4, "valid": 4}),
             ("serve.request", -1, 5, 9, None, {}),
             ("select", 2, 5.5, 8, 2.0, {"slots": 4, "valid": 4})]
    tr = _trace(bench=(("request_input", 0.5, 0.9), ("predict", 1, 4.01),
                       ("request_input", 4.5, 4.9), ("predict", 5, 9.01)))
    rec = _record(tr, _raw(serve, 50), monkeypatch)
    assert core.metric_reader("select_ms.serve")(rec) == pytest.approx(1.5)


@pytest.mark.parametrize("case", ["units", "outside", "empty", "dropped",
                                  "no_events"])
def test_none_where_the_window_cannot_be_trusted(monkeypatch, case):
    raw, trace, dropped = _raw(TRAIN, 1000), _trace(), 0
    if case == "units":
        # the trace counted 3 steps, the program 2
        trace = _trace(units=3)
    elif case == "outside":
        # the benchmark's epoch ends 1.99 ms before the program's
        trace = _trace(bench=(("train_one_epoch", 1, 17),))
    elif case == "empty":
        # the parent of this change records nothing
        raw = []
    elif case == "dropped":
        dropped = 1
    rec = _record(trace, raw if case != "no_events"
                  else _raw(TRAIN, 1000, events=False), monkeypatch,
                  dropped)
    got = _read(rec, *TRAIN_METRICS)
    if case == "no_events":
        # a run whose spans carry no device time (on the CPU) reads the
        # host's numbers and no event times
        assert got["select_ms.train"] is None
        assert got["regrad_ms.train"] is None
        assert got["step_host_ms.train"] == pytest.approx(6.0)
        return
    assert all(v is None for v in got.values()), got


def test_a_program_without_a_recorder_reads_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def without(name, *a, **kw):
        if name == "ips_tpu_torch.utils.profiling":
            raise ImportError("cannot import name 'RECORDER'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", without)
    assert program_spans._take() == ([], 0)
    rec = core.Record("mnist.train", {}, {}, trace=_trace(), steps=2)
    assert all(v is None for v in _read(rec, *TRAIN_METRICS).values())
