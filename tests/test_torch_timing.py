"""utils/timing.device_time_ms against a stubbed profiler: a kernel's time a
launch is its total over the records the trace kept, its record count comes
back beside it, a turn that kept fewer records than launches is flagged, and
the benches' turn logic (kernels/tier_bench.time_case over
utils/timing.device_time_turn) repeats such a turn once. Nothing here needs
a card: torch.profiler.profile, torch.cuda.synchronize and the timers are
stubbed.
"""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from phys_autodiff_tpu_torch.kernels import tier_bench
from phys_autodiff_tpu_torch.utils import timing


def _event(key, total_us, count, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(key=key, device_type=device, self_device_time_total=total_us, count=count,
                           is_user_annotation=annotation)


class _Profiler:
    """torch.profiler.profile for a call that launches k_a twice (30 us
    each) and k_b once (50 us): a trace of n calls keeps every record of
    k_a and, past one call, loses `lost` records of k_b; a CPU op and a user
    annotation ride along."""

    calls = [0]
    lost = 1

    def __init__(self, activities):
        self.activities = activities

    def __enter__(self):
        self.start = _Profiler.calls[0]
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        n = _Profiler.calls[0] - self.start
        kept_b = n - (_Profiler.lost if n > 1 else 0)
        return [_event("k_a", 60.0 * n, 2 * n), _event("k_b", 50.0 * kept_b, kept_b),
                _event("aten::add", 7.0, n, device=DeviceType.CPU),
                _event("Optimizer.step#Adam.step", 500.0, n, annotation=True)]


@pytest.fixture
def stubbed(monkeypatch):
    _Profiler.calls[0] = 0
    _Profiler.lost = 1
    monkeypatch.setattr(torch.profiler, "profile", _Profiler)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)

    def fn():
        _Profiler.calls[0] += 1

    return fn


def test_time_a_launch_is_over_the_records_kept(stubbed):
    times = timing.device_time_ms(stubbed, calls=10)
    assert _Profiler.calls[0] == 1 + 1 + 10  # warm-up, the one-call trace, the turn
    assert set(times) == {"k_a", "k_b"}  # no CPU op, no mirrored annotation
    a, b = times["k_a"], times["k_b"]
    assert (a.count, a.per_call) == (20, 2) and a.ms == pytest.approx(0.030) and a.call_ms == pytest.approx(0.060)
    # 9 of k_b's 10 records kept: 50 us a launch all the same (the old
    # total / calls read 0.045 ms), one launch a call
    assert (b.count, b.per_call) == (9, 1) and b.ms == pytest.approx(0.050) and b.call_ms == pytest.approx(0.050)
    assert timing.call_ms(times) == pytest.approx(0.110)
    assert timing.dropped(times, 10) == ["k_b"]


def test_no_drop_no_flag(stubbed):
    _Profiler.lost = 0
    times = timing.device_time_ms(stubbed, calls=10)
    assert timing.dropped(times, 10) == [] and times["k_b"].count == 10


def test_a_kernel_with_every_record_lost_keeps_its_one_call_time(stubbed):
    _Profiler.lost = 10
    times = timing.device_time_ms(stubbed, calls=10)
    assert times["k_b"].count == 0 and times["k_b"].per_call == 1 and times["k_b"].ms == pytest.approx(0.050)
    assert timing.dropped(times, 10) == ["k_b"]


def _turns(*drops):
    """A device_time_ms stub whose successive turns lose drops[i] records
    of k_b (2 launches of k_a, 1 of k_b a call)."""
    seen = []

    def device_time_ms(fn, calls=10):
        lost = drops[len(seen)]
        seen.append(lost)
        return {"k_a": timing.KernelTime(0.03, 2 * calls, 2),
                "k_b": timing.KernelTime(0.05, calls - lost, 1)}

    return device_time_ms, seen


@pytest.mark.parametrize("drops,flagged", [((3, 0), False), ((3, 2), True), ((0,), False)])
def test_tier_bench_flags_and_repeats_a_turn(monkeypatch, drops, flagged):
    stub, seen = _turns(*drops)
    monkeypatch.setattr(timing, "device_time_ms", stub)
    monkeypatch.setattr(timing, "cuda_time_ms", lambda fn: 0.5)
    log, times = [], {}
    tier_bench.time_case("K2 bf16", lambda: None, times, log=log.append)
    assert seen == list(drops[:2]) if drops[0] else seen == [0]
    ev, dev, split = times["K2 bf16"]
    assert ev == 0.5 and split == pytest.approx({"k_a": 0.06, "k_b": 0.05}) and dev == pytest.approx(0.11)
    repeats = [m for m in log if "repeating the turn" in m]
    assert len(repeats) == (1 if drops[0] else 0)
    assert ("k_b 7 of 10" in repeats[0]) if repeats else True
    assert any("DROPPED RECORDS" in m for m in log) == flagged


def test_split_rows_cut_k4s_passes():
    times = {"K4 bf16": (0.5, 0.44, {"void (anonymous namespace)::k_bwd_fields<true>(...)": 0.105,
                                     "void (anonymous namespace)::k_bwd_adjoint_bf16(...)": 0.273,
                                     "k_residuals<3>": 0.032})}
    rows = tier_bench.split_rows(times)
    assert rows == pytest.approx({"K4 bf16 fields pass": 0.105, "K4 bf16 adjoint pass": 0.273})


@pytest.mark.parametrize("perfetto", [False, True])
def test_trace_writes_a_trace_that_holds_the_annotation(tmp_path, perfetto):
    """utils/timing.trace on the CPU (no card: the host's activity only)
    writes a Chrome / Perfetto JSON trace into log_dir whose events hold
    an `annotate` scope and the ops run inside it."""
    import gzip
    import json

    with timing.trace(str(tmp_path), perfetto=perfetto) as tr:
        with timing.annotate("train_step"):
            x = torch.ones(64, 64)
            (x @ x).sum()
    assert tr.path is not None and tr.path.startswith(str(tmp_path))
    assert tr.path.endswith(".json.gz" if perfetto else ".json")
    opener = gzip.open if perfetto else open
    with opener(tr.path, "rt") as f:
        events = json.load(f)["traceEvents"]
    scope = [e for e in events if e.get("name") == "train_step" and e.get("ph") == "X"]
    assert len(scope) == 1
    t0, t1 = scope[0]["ts"], scope[0]["ts"] + scope[0]["dur"]
    inside = {e["name"] for e in events if e.get("ph") == "X" and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1}
    assert {"aten::mm", "aten::sum"} <= inside


def test_trace_is_written_when_the_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with timing.trace(str(tmp_path)) as tr:
            with timing.annotate("failing"):
                1 / 0
    assert tr.path is not None and "failing" in open(tr.path).read()
