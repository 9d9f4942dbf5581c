"""The readers of the program's spans (core/spans.py and the six metrics
that read it) on a synthetic profiler trace (torch.profiler's Chrome JSON)
of three training steps traced with host activity: a pull-back whose
kernels are launched from another host thread, waits inside and outside
the step, and idle gaps inside the step and during the benchmark's loss
read."""

from __future__ import annotations

import pytest

from portbench.core import spans, specs
from portbench.core.harness import ReadContext
from portbench.core.trace import DEVICE_CATS, Trace
from portbench.core.window import Window
from portbench.tests.conftest import ROOT

FWD = "void at::native::elementwise_kernel<128, 4>(int)"
HEAD = "void (anonymous namespace)::k_ngp_adjoint<2, 1>(float const*, int)"
PULL = "ampere_sgemm_64x32_tn"
ADAM = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::TensorListMetadata<4> >(int)"
STEP_US, STEPS = 1000.0, 3
MAIN, AUTOGRAD, DEVICE = 1, 2, 7


def _events(fwd="pat.encode", back="pat.encode.pullback", program_spans=True):
    """Three steps of 1000 us. On the host, in each: the harness's
    portbench.step (0-700 us) holding the program's pat.step (1 us to
    690-698 us), in which the forward span (5-30 us) launches FWD, the head
    kernel is launched outside any span, and the pull-back span (50-300 us)
    waits on the main thread while the autograd thread launches PULL;
    Adam's kernel under Optimizer.step; a cudaStreamSynchronize inside
    pat.step in step 0, a synchronous cudaMemcpy in step 1 and a
    cudaMemcpyAsync in step 2; then portbench.read (700-1000 us) with its
    copy and synchronise. On the device: FWD 20-120, HEAD 120-420, PULL
    450-650, ADAM 660-690, the read's copy 900-910: idle inside pat.step
    0-20 (step 0), 420-450 and 650-660 (each step), and during the read."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0.0, "dur": STEPS * STEP_US,
           "tid": MAIN}]
    corr = 0

    def host(cat, name, ts, dur, tid=MAIN, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args})

    def launch(name, ts, dur, host_ts, tid=MAIN, cat="kernel", call="cudaLaunchKernel"):
        nonlocal corr
        corr += 1
        host("cuda_runtime", call, host_ts, 4.0, tid, correlation=corr)
        host(cat, name, ts, dur, DEVICE, correlation=corr)

    for s in range(STEPS):
        t0 = s * STEP_US
        host("user_annotation", "portbench.step", t0, 700.0)
        if program_spans:
            host("user_annotation", "pat.step", t0 + 1, 689.0 + 4 * s)
            host("user_annotation", fwd, t0 + 5, 25.0)
            host("user_annotation", back, t0 + 50, 250.0)
        launch(FWD, t0 + 20, 100.0, t0 + 10)
        launch(HEAD, t0 + 120, 300.0, t0 + 40)
        host("cpu_op", "autograd::engine::evaluate_function: MmBackward0", t0 + 55, 20.0, AUTOGRAD)
        launch(PULL, t0 + 450, 200.0, t0 + 60, tid=AUTOGRAD)
        host("user_annotation", "Optimizer.step#Adam.step", t0 + 310, 20.0)
        launch(ADAM, t0 + 660, 30.0, t0 + 320)
        host("cuda_runtime", ("cudaStreamSynchronize", "cudaMemcpy", "cudaMemcpyAsync")[s], t0 + 400, 5.0)
        host("user_annotation", "portbench.read", t0 + 700, 300.0)
        launch("Memcpy DtoH (Device -> Pageable)", t0 + 900, 10.0, t0 + 710, cat="gpu_memcpy",
               call="cudaMemcpyAsync")
        host("cuda_runtime", "cudaStreamSynchronize", t0 + 715, 200.0)
    return ev


def _ctx(cell="ngp_train_256", **kw):
    host = Trace(_events(**kw), units=STEPS)
    device_only = Trace([e for e in _events(**kw) if e["cat"] in DEVICE_CATS], units=STEPS,
                        host_window_s=STEPS * STEP_US / 1e6)
    w = Window(units=STEPS, attempted=STEPS, failed=0, window_s=STEPS * STEP_US / 1e6)
    return ReadContext(device_only, w, specs.load_cell(ROOT, cell), frozenset({"k_ngp_adjoint"}), host_trace=host)


def _read(name, ctx):
    return specs.metric_reader(name)(ctx)


def test_a_pull_back_launched_from_another_thread_is_counted():
    ctx = _ctx()
    tr = ctx.host_trace
    assert _read("encode_ms.train", ctx) == pytest.approx(0.1)
    assert _read("encode_pullback_ms.train", ctx) == pytest.approx(0.2)
    # the same-thread rule of Trace.launched_under would miss the pull-back
    assert tr.per_unit_ms(lambda r: tr.launched_under(r, "pat.encode.pullback")) is None
    # the encoder's two spans hold all of torch_ops_ms but the optimizer's kernels and the head
    assert _read("torch_ops_ms.train", ctx) == pytest.approx(0.3)


def test_folds_read_both_of_their_spans():
    ctx = _ctx("mlp_train_256", fwd="pat.fold", back="pat.fold.pullback")
    assert _read("folds_ms.train", ctx) == pytest.approx(0.3)
    assert _read("encode_ms.train", ctx) is None


def test_host_ms_a_step_is_the_median_step_span():
    assert _read("step_host_ms.train", _ctx()) == pytest.approx(0.693)


def test_waits_count_blocking_calls_inside_the_step_alone():
    """The synchronise in step 0 and the synchronous copy in step 1 count;
    the asynchronous copy in step 2 and the three in portbench.read do not."""
    assert _read("step_waits.train", _ctx()) == pytest.approx(2 / 3)


def test_idle_counts_gaps_inside_the_step_alone():
    """Inside pat.step: 20 + 30 + 10 us in step 0 (its start), 30 + 10 us in
    each later step, the median 40 us; the gaps around the read's copy lie
    outside it."""
    ctx = _ctx()
    assert _read("step_idle_ms.train", ctx) == pytest.approx(0.04)
    all_idle_ms = (STEPS * STEP_US - ctx.host_trace.busy_s() * 1e6) / 1e3 / STEPS
    assert _read("step_idle_ms.train", ctx) < all_idle_ms / 5


@pytest.mark.parametrize("name", ["encode_ms.train", "encode_pullback_ms.train", "folds_ms.train",
                                  "step_host_ms.train", "step_waits.train", "step_idle_ms.train"])
def test_readers_return_nothing_without_their_spans(name):
    """A program without the spans (the trace holds the harness's ranges
    alone), and an empty trace: no reading, never 0."""
    ctx = _ctx(program_spans=False)
    assert _read(name, ctx) is None
    empty = ReadContext(ctx.trace, ctx.window, ctx.cell, ctx.kernel_names, host_trace=Trace([], units=STEPS))
    assert _read(name, empty) is None
    # the window traced with CUDA activity alone holds no span either
    assert _read(name, ReadContext(ctx.trace, ctx.window, ctx.cell, ctx.kernel_names)) is None


def test_spans_are_host_ranges_in_time_order():
    tr = _ctx().host_trace
    steps = spans.spans(tr, spans.STEP)
    assert [s.ts for s in steps] == [1.0, 1001.0, 2001.0]
    assert spans.spans(tr, "pat.fold") == []
