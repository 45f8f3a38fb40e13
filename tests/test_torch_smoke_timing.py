"""chip_smoke.py's timing helpers on the CPU, with the profiler replaced
by fixed profiles: which timer a kernel's JSON entry reports, and when a
breakdown refuses a profile that lost kernel records."""

import importlib.util
import os

import pytest

from ips_tpu_torch.ops import score_kernel as sk
from ips_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGITS = "void (anonymous namespace)::score_logits_cu::logits_f32<4>"


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(ms, plain_ms, library_ms):
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "event_ms": 0.02, "event_plain_ms": 0.03,
            "event_library_ms": 0.04,
            "refused_profiles": [] if None not in (ms, plain_ms, library_ms)
            else [{"k": 9}]}


@pytest.mark.parametrize("row,want", [
    (_row(0.01, 0.011, 0.012),
     {"ms": 0.01, "plain_ms": 0.011, "library_ms": 0.012,
      "ms_by": "profiler"}),
    (_row(0.01, None, 0.012),
     {"ms": 0.02, "plain_ms": 0.03, "library_ms": 0.04, "ms_by": "events"})],
    ids=["whole", "refused"])
def test_timing_fields_name_their_timer(smoke, row, want, capsys):
    """Where every profile was whole the entry carries the profiler's
    times; where one was refused, all three event times, said so."""
    assert smoke.timing_fields(row, 0.001) == want
    out = capsys.readouterr().out
    assert ("CUDA-event times" in out) == (want["ms_by"] == "events")


@pytest.mark.parametrize("profiles,want_ms", [
    ([{LOGITS: (6.0, 6), "gemm": (994.0, 3)}], 1.0),
    ([{LOGITS: (5.0, 5), "gemm": (995.0, 3)},
      {LOGITS: (6.0, 6), "gemm": (1994.0, 3)}], 2.0),
    ([{LOGITS: (5.0, 5), "gemm": (995.0, 3)}] * timing.PROFILE_TRIES,
     None),
    ([{}], None)],
    ids=["whole", "retaken", "never_whole", "nothing_seen"])
def test_breakdown_refuses_lost_records(smoke, monkeypatch, profiles,
                                        want_ms):
    """A profile that holds fewer score_logits records than the wrapper
    counted launches in it is taken again; with no whole one in
    PROFILE_TRIES, no busy time (and so no idle share) is reported."""
    it = iter(profiles)

    def fake_profile(fn, iters=1):
        fn()
        return next(it)
    monkeypatch.setattr(timing, "device_kernels", fake_profile)
    monkeypatch.setattr(sk.logits, "launches", 0)

    def request():
        sk.logits.launches += 6
    busy = smoke.breakdown(None, request, 0.01)
    assert busy == (None if want_ms is None else pytest.approx(want_ms))
