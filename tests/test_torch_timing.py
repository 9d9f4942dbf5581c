"""utils/timing.device_time_ms against a stubbed profiler: a kernel's time a
launch is its total over the records the trace kept, its record count comes
back beside it, a turn that kept fewer records than launches is flagged, and
the benches' turn logic (kernels/tier_bench.time_case over
utils/timing.device_time_turn) repeats such a turn once. Nothing here needs
a card: torch.profiler.profile, torch.cuda.synchronize and the timers are
stubbed.

Then `annotate` under a CPU profiler (a span with its name and id; none, and
no cost but a check, without a profiler), and the program's spans in the
training steps at a small grid under utils/timing.trace: one `pat.step` a
step with its index, the folds' or the encoder's pair of spans inside it.
"""

import contextlib
import json
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


def _spans(events, name):
    return [e for e in events if e.get("ph") == "X" and e.get("name") == name and e.get("cat") == "user_annotation"]


def test_annotate_records_a_span_with_its_name_and_id():
    """Under a CPU profiler that records inputs, a span is a user annotation
    holding the ops run inside it, its id its one input."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with timing.annotate("pat.step", 7):
            with timing.annotate("pat.fold"):
                torch.ones(8) * 2
    events = prof.events()
    step = [e for e in events if e.name == "pat.step"]
    fold = [e for e in events if e.name == "pat.fold"]
    assert len(step) == 1 and len(fold) == 1
    assert step[0].concrete_inputs == [7] and fold[0].concrete_inputs == []
    assert step[0].time_range.start <= fold[0].time_range.start <= fold[0].time_range.end <= step[0].time_range.end
    assert any(e.name == "aten::mul" and fold[0].time_range.start <= e.time_range.start <= fold[0].time_range.end
               for e in events)


def test_annotate_without_a_profiler_is_the_shared_no_op():
    """No profiler: the one shared no-op context, and a profiler started
    afterwards holds nothing of it."""
    from torch.profiler import ProfilerActivity, profile

    span = timing.annotate("pat.step", 3)
    assert isinstance(span, contextlib.nullcontext) and span is timing.annotate("pat.encode")
    with span:
        torch.ones(4) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4) + 1
    assert not [e for e in prof.events() if e.name.startswith("pat.")]


def test_annotate_closes_the_span_when_the_body_raises(tmp_path):
    """The exception leaves the span closed at the raise: the op after it
    lies outside the span."""
    with timing.trace(str(tmp_path)) as tr:
        with pytest.raises(ZeroDivisionError):
            with timing.annotate("pat.step", 2):
                torch.ones(4) + 1
                1 / 0
        torch.ones(4) * 3
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    (span,) = _spans(events, "pat.step")
    assert span["args"]["Concrete Inputs"] == ["2"]
    (after,) = [e for e in events if e.get("name") == "aten::mul"]
    assert span["ts"] <= span["ts"] + span["dur"] <= after["ts"]


def _mlp_step():
    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.train import loop

    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    cfg = loop.TrainConfig(learning_rate=1e-3, seed=3, t_sampling="uniform", use_fused=True)
    return loop.make_train_step(g, PhysWeights(), mcfg, cfg), loop.init_state(cfg, mcfg, device="cpu")


def _ngp_cfg():
    from phys_autodiff_tpu_torch import GridSpec
    from phys_autodiff_tpu_torch.models import ngp
    from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig

    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    enc = HashEncodingConfig(num_levels=3, features_per_level=2, log2_table_size=7, base_resolution=3,
                             max_resolution=8)
    ncfg = ngp.NGPFieldConfig(encoding=enc, hidden=16)
    return g, ncfg, ngp.init_ngp_params(ncfg, seed=1, device="cpu")


def _ngp_step():
    from phys_autodiff_tpu_torch import PhysWeights
    from phys_autodiff_tpu_torch.train import loop

    g, ncfg, params0 = _ngp_cfg()
    cfg = loop.TrainConfig(learning_rate=1e-3, seed=3, t_sampling="uniform")
    return loop.make_ngp_train_step(g, PhysWeights(), ncfg, cfg, params0, backward="mega")


def _fit_step():
    from phys_autodiff_tpu_torch.train import fit_field, loop

    g, ncfg, params0 = _ngp_cfg()
    gen = torch.Generator().manual_seed(5)
    target = fit_field.FitTarget(torch.randn(g.shape, generator=gen), torch.randn((3,) + g.shape, generator=gen), 0.25)
    cfg = loop.TrainConfig(learning_rate=5e-3, seed=3)
    return fit_field.make_fit_step(g, ncfg, [target], cfg, params0=params0, engine="mega", device="cpu")


@pytest.mark.parametrize("make,inner", [(_mlp_step, ("pat.fold", "pat.fold.pullback")),
                                        (_ngp_step, ("pat.encode", "pat.encode.pullback")),
                                        (_fit_step, ("pat.encode", "pat.encode.pullback"))],
                         ids=["mlp_k4_plain", "ngp_k5_plain", "ngp_fit_k7_plain"])
def test_training_steps_leave_their_spans(tmp_path, make, inner):
    """Three steps of each training step under utils/timing.trace: one
    `pat.step` a step with the step's index, and in each the two spans of
    its layer, in order, the pull-back's ops inside the pull-back's span;
    no other span of the program's."""
    step, state = make()
    state, _ = step(state)  # outside the trace
    with timing.trace(str(tmp_path)) as tr:
        for _ in range(3):
            state, _ = step(state)
    with open(tr.path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(_spans(events, "pat.step"), key=lambda e: e["ts"])
    assert [e["args"]["Concrete Inputs"] for e in steps] == [["1"], ["2"], ["3"]]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("pat.")}
    assert names == {"pat.step", *inner}
    for s in steps:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        (fwd,), (back,) = ([e for e in _spans(events, n) if lo <= e["ts"] <= hi] for n in inner)
        assert lo <= fwd["ts"] and fwd["ts"] + fwd["dur"] <= back["ts"] and back["ts"] + back["dur"] <= hi
        b0, b1 = back["ts"], back["ts"] + back["dur"]
        assert any(e.get("cat") == "cpu_op" and "Backward" in e["name"] and b0 <= e["ts"] <= b1 for e in events)
