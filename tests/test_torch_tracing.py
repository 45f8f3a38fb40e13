"""The port's spans (``ips_tpu_torch.utils.profiling.span``) on the CPU.

Off (no profiler) a span reads no clock and makes no CUDA event; under
``torch.profiler`` spans nest with the right parents, and device-timed
ones resolve their events, and count a tensor on the card, only when
read. One epoch of each train schedule (grouped
sparse steps, grouped dense steps, assembled steps, streamed selection)
gives one ``train.step`` per optimizer step, holding every ``select``,
``regrad`` and ``adamw``, and ``select``'s ``slots`` / ``valid`` equal
hand counts. A request gives one ``serve.request`` holding one
``select``, and ``main``'s ``profile_dir`` trace carries the spans as
ranges.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ips_tpu_torch.config import config_from_dict
from ips_tpu_torch.data.loader import DataLoader
from ips_tpu_torch.data.mnist import MegapixelMNIST, generate_megapixel_mnist
from ips_tpu_torch.infer import Predictor
from ips_tpu_torch.main import main
from ips_tpu_torch.train import loop
from ips_tpu_torch.train.loop import train_one_epoch
from ips_tpu_torch.train.metrics import MetricsLogger
from ips_tpu_torch.train.steps import IPSTrainer
from ips_tpu_torch.utils import profiling
from ips_tpu_torch.utils.profiling import (RECORDER, EfficiencyTracker,
                                         span)

from test_torch_data import conf_dict

N, M = 16, 4        # 200x200 images in 50x50 patches


@pytest.fixture(autouse=True)
def empty_recorder():
    """Spans other tests of this process recorded under their profilers
    are not this test's."""
    RECORDER.clear()
    yield
    RECORDER.clear()


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mnist_tracing"))
    generate_megapixel_mnist(d, n_train=10, n_test=4, width=200, height=200,
                             n_noise=4, digit_source="synthetic")
    return d


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _inside(spans, i, name):
    """Whether span ``i`` has an ancestor named ``name``."""
    p = spans[i].parent
    while p != -1:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def test_off_reads_no_clock_and_makes_no_event(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("called while the profiler is off")

    class NoClock:
        perf_counter_ns = staticmethod(boom)

    monkeypatch.setattr(profiling, "time", NoClock)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    monkeypatch.setattr(torch.cuda, "current_stream", boom)
    assert not torch.autograd.profiler._is_profiler_enabled
    with span("select", torch.device("cuda", 0), slots=3) as s:
        s.set(valid=np.ones(4, bool))
        s.add(slots=2)
        with span("select.stage"):
            pass
    assert RECORDER.take() == ([], 0)


def test_spans_nest_under_the_profiler():
    with _cpu_profile():
        with span("a"):
            with span("b", torch.device("cpu")) as b:
                b.set(slots=3)
                b.add(slots=2)
                with span("c"):
                    pass
            with span("d", n=2):
                pass
        with span("e"):
            pass
    spans, dropped = RECORDER.take()
    assert dropped == 0
    assert [(s.name, s.parent) for s in spans] == [
        ("a", -1), ("b", 0), ("c", 1), ("d", 0), ("e", -1)]
    assert spans[1].counts == {"slots": 5} and spans[3].counts == {"n": 2}
    for s in spans:
        assert s.device_ms is None and s.start_ns <= s.end_ns
        if s.parent != -1:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert RECORDER.take() == ([], 0)


def test_counts_and_events_resolve_when_read(monkeypatch):
    calls = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            calls.append("new")

        def record(self, stream):
            assert stream == "stream"
            calls.append("record")

        def synchronize(self):
            calls.append("sync")

        def elapsed_time(self, end):
            calls.append("elapsed")
            return 2.5

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: "stream")

    class OnCard(torch.Tensor):
        """A CPU tensor that says it is on the card."""
        @property
        def device(self):
            return torch.device("cuda", 0)

    mask = torch.tensor([[True, False, True], [False, False, True]])
    rows = np.array([1, 0, 1])
    with _cpu_profile():
        with span("select", torch.device("cuda", 0)) as s:
            s.set(slots=6, valid=mask.as_subclass(OnCard), rows=rows,
                  here=mask)
    assert calls == ["new", "new", "record", "record"]
    # a tensor on the card is counted when read, the rest when set
    mask[:] = True
    rows[:] = 0
    spans, _ = RECORDER.take()
    assert calls[4:] == ["sync", "elapsed"]
    assert spans[0].device_ms == 2.5
    assert spans[0].counts == {"slots": 6, "valid": 6, "rows": 2,
                               "here": 3}


def test_the_bound_drops_and_counts():
    rec = profiling.SpanRecorder(limit=2)
    for name in "abc":
        with rec.open(name):
            pass
    spans, dropped = rec.take()
    assert [s.name for s in spans] == ["a", "b"] and dropped == 1
    assert rec.take() == ([], 0)


def _slots(N, M, I):
    return M + -(-(N - M) // I) * I


# (overrides, loader batches of the 10 images, rows a select)
SCHEDULES = {
    "sparse_grouped": (dict(steps_per_dispatch=2), 4),
    "dense_single": (dict(sparse_input=False), 4),
    "assembled": (dict(sparse_input=False, B_seq=2, steps_per_dispatch=2),
                  2),
    "streamed": (dict(sparse_input=False, eager=False, B_seq=2, I=5), 2),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_one_epoch_of_each_schedule(data_dir, schedule):
    over, rows = SCHEDULES[schedule]
    conf = config_from_dict(conf_dict(data_dir, **over))
    tr = IPSTrainer(conf, device="cpu")
    loader = DataLoader(MegapixelMNIST(conf, train=True),
                        batch_size=conf.B_seq, shuffle=True, seed=0)
    with _cpu_profile():
        train_one_epoch(tr, loader, 0, MetricsLogger(conf.task_list), conf)
    spans, dropped = RECORDER.take()
    assert dropped == 0
    names = [s.name for s in spans]
    assert names[0] == "train.epoch" and spans[0].parent == -1
    assert all(s.parent != -1 for s in spans[1:])
    assert names.count("train.step") == tr.step == 3
    assert names.count("adamw") == names.count("regrad") == tr.step
    for i, s in enumerate(spans):
        if s.name in ("select", "regrad", "adamw", "select.stage"):
            assert _inside(spans, i, "train.step"), (i, s.name)
        if s.name == "train.step":
            assert not _inside(spans, i, "train.step")
    # every loader batch is one data.next, and one more meets the end
    batches = len(loader)
    assert names.count("data.next") == batches + 1
    selects = [s for s in spans if s.name == "select"]
    # the 10 images in batches of B_seq; a short last batch is padded
    # with invalid rows (eager) or streamed as it comes
    sizes = [min(conf.B_seq, 10 - k * conf.B_seq) for k in range(batches)]
    assert len(selects) == batches * conf.B_seq // rows
    I = conf.I
    assert sum(s.counts["slots"] for s in selects) == \
        (batches * conf.B_seq if conf.eager else sum(sizes)) \
        * _slots(N, M, I)
    assert sum(s.counts["valid"] for s in selects) == 10 * N
    if not conf.eager:
        stages = [s for s in spans if s.name == "select.stage"]
        # per slide: the first M, ceil((N - M) / I) chunks one at a time
        # (G = 1), the kept patches
        assert len(stages) == batches * (1 + -(-(N - M) // I) + 1)
        assert all(not s.counts for s in stages)


class LoggedTracker(EfficiencyTracker):
    """Logs where the steps' timing starts and stops."""

    def __init__(self, conf, log):
        super().__init__(conf)
        self.log = log

    def start(self):
        self.log.append("start")

    def stop(self, epoch, data_it, is_last_batch):
        self.log.append("stop")

    def finish_epoch(self, epoch):
        pass


def test_step_time_holds_its_batches_preparation(data_dir, monkeypatch):
    """The select-assemble-train loop starts a step's timing before its
    first loader batch is prepared, as before the loop prefetched."""
    log = []
    prep_host = loop._prep_host

    def logged(*a):
        log.append("prep")
        return prep_host(*a)

    monkeypatch.setattr(loop, "_prep_host", logged)
    conf = config_from_dict(conf_dict(data_dir, sparse_input=False,
                                      eager=False, B_seq=2, I=5))
    tr = IPSTrainer(conf, device="cpu")
    loader = DataLoader(MegapixelMNIST(conf, train=True),
                        batch_size=conf.B_seq, shuffle=True, seed=0)
    train_one_epoch(tr, loader, 0, MetricsLogger(conf.task_list), conf,
                    LoggedTracker(conf, log))
    # 5 loader batches of 2 into steps of 4 rows
    assert log == ["start", "prep", "prep", "stop"] * 2 + [
        "start", "prep", "stop"]


def test_slots_streamed_step_time_holds_its_preparation(monkeypatch):
    """So does the streamed schedule of B_seq < B over data ranks."""
    log = []

    def prep_slots(trainer, conf, base, epoch, steps_seq, host, ib):
        log.append("prep")
        return loop._Slots(ib[0], {}, {}, None, [], 0, 0.1)

    class Trainer:
        def new_generator(self, seed):
            return None

        def train_step(self, *args):
            log.append("step")
            return ()

    monkeypatch.setattr(loop, "_prep_slots", prep_slots)
    monkeypatch.setattr(loop, "_streamed_slots", lambda *a: ())
    monkeypatch.setattr(loop, "_log_slots", lambda *a: None)
    conf = SimpleNamespace(B=4, B_seq=2, track_efficiency=True,
                           track_epoch=0)
    loop._epoch_slots_streamed(Trainer(), [0, 1, 2], 0, None, conf, 0,
                               True, LoggedTracker(conf, log))
    assert log == ["start", "prep", "step", "stop"] * 3


def test_streamed_select_counts_the_mask(data_dir):
    conf = config_from_dict(conf_dict(data_dir, sparse_input=False,
                                      eager=False, I=5))
    tr = IPSTrainer(conf, device="cpu")
    rng = np.random.default_rng(0)
    patches = rng.random((3, N, 50, 50, 1), np.float32)
    mask = np.ones((3, N), bool)
    mask[1, 9:] = False
    mask[2, 5:] = False
    with _cpu_profile():
        tr.select_streaming(patches, mask, tr.new_generator(1))
        tr.select(torch.from_numpy(patches), torch.from_numpy(mask),
                  tr.new_generator(1))
    spans, _ = RECORDER.take()
    selects = [s for s in spans if s.name == "select"]
    assert len(selects) == 2
    for s in selects:
        assert s.counts == {"slots": 3 * (4 + 5 * 3),
                            "valid": N + 9 + 5}


def test_one_request_is_one_span_holding_one_select(data_dir):
    conf = config_from_dict(conf_dict(data_dir))
    pred = Predictor(conf, device="cpu")
    x = np.random.default_rng(0).random((2, N, 50, 50, 1), np.float32)
    with _cpu_profile():
        pred.predict(x)
    spans, _ = RECORDER.take()
    assert [(s.name, s.parent) for s in spans] == [("serve.request", -1),
                                                   ("select", 0)]
    assert spans[1].counts == {"slots": 2 * 16, "valid": 2 * 16}


def test_profile_dir_trace_carries_the_spans(data_dir, tmp_path):
    path = str(tmp_path / "config.json")
    with open(path, "w") as f:
        json.dump(conf_dict(data_dir, n_epoch=1, n_worker=2,
                            steps_per_dispatch=2), f)
    main(["--config", path, "--device", "cpu",
          f"profile_dir={tmp_path / 'trace'}"])
    with open(os.path.join(tmp_path, "trace", "epoch_0.json")) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    assert names.count("train.step") == 3
    assert names.count("train.epoch") == 1
    assert {"select", "regrad", "adamw", "data.next"} <= set(names)
    # nothing read the recorder, and nothing is left in it
    assert RECORDER.take() == ([], 0)
