"""The per-layer readers on a synthetic profiler trace (torch.profiler's
Chrome JSON), a dropped record included."""

from __future__ import annotations

import math

import pytest

from portbench.core import specs, work
from portbench.core.harness import ReadContext
from portbench.core.trace import DEVICE_CATS, Trace, kernel_base_name
from portbench.core.window import Window
from portbench.tests.conftest import ROOT

K4 = "void (anonymous namespace)::k_bwd_fields<false, false>(float const*, float const*, int)"
ADJ = "void (anonymous namespace)::k_bwd_adjoint(float const*, int)"
GEMM = "ampere_sgemm_128x64_nn"
ADAM = "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::TensorListMetadata<4> >(int)"
STEP_US = 1000.0


def _events():
    """Two steps of 1000 us: in each, the K4 fields kernel (300 us), its
    adjoint (400 us; one of its two records dropped), a cuBLAS kernel (100
    us, the host's matmul) and Adam's kernel (50 us, launched under
    Optimizer.step), then the host idles; a loss read's memcpy in step 2."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0.0, "dur": 2 * STEP_US, "tid": 1}]
    corr = 0

    def launch(name, ts, dur, host_ts, under_opt=False, drop=False):
        nonlocal corr
        corr += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": host_ts, "dur": 5.0,
                   "tid": 1, "args": {"correlation": corr}})
        if not drop:
            ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
                       "args": {"correlation": corr}})

    for s in range(2):
        t0 = s * STEP_US
        ev.append({"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": t0, "dur": 900.0, "tid": 1})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t0, "dur": 20.0, "tid": 1})
        launch(GEMM, t0 + 10, 100.0, t0 + 2)
        launch(K4, t0 + 110, 300.0, t0 + 30)
        launch(ADJ, t0 + 410, 400.0, t0 + 40, drop=(s == 1))
        ev.append({"ph": "X", "cat": "user_annotation", "name": "Optimizer.step#Adam.step", "ts": t0 + 50,
                   "dur": 30.0, "tid": 1})
        launch(ADAM, t0 + 810, 50.0, t0 + 60, under_opt=True)
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)", "ts": 1870.0,
               "dur": 10.0, "tid": 7, "args": {"correlation": 99}})
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "Optimizer.step#Adam.step", "ts": 0, "dur": 2000.0,
               "tid": 7})
    return ev


def _ctx(cell_name="mlp_train_256", host_s=()):
    cell = specs.load_cell(ROOT, cell_name)
    tr = Trace(_events(), units=2, host_window_s=0.002)
    return ReadContext(tr, Window(units=2, attempted=2, failed=0, window_s=0.002, host_s=list(host_s)), cell,
                       frozenset({"k_bwd_fields", "k_bwd_adjoint", "k_residuals"}))


def _read(name, ctx):
    return specs.metric_reader(name)(ctx)


def test_kernel_names():
    assert kernel_base_name(K4) == "k_bwd_fields"
    assert kernel_base_name(ADAM) == "multi_tensor_apply_kernel"
    assert kernel_base_name(GEMM) == GEMM


def test_k4_roofline_counts_a_dropped_record_as_launched():
    ctx = _ctx()
    # 300 us + 400 us a step (the adjoint's one kept record stands for both)
    assert ctx.trace.per_unit_ms(ctx.kernels_named(("k_bwd_fields", "k_bwd_adjoint"))) == pytest.approx(0.7)
    least_ms = work.least_time_s(*work.kernel_work("K4", ctx.config)) * 1e3
    assert _read("k4_roofline", ctx) == pytest.approx(100 * least_ms / 0.7)
    assert ctx.trace.dropped() == [ADJ]


def test_optimizer_and_torch_ops_split():
    ctx = _ctx()
    assert _read("optimizer_ms.train", ctx) == pytest.approx(0.05)
    assert _read("torch_ops_ms.train", ctx) == pytest.approx(0.1)  # the cuBLAS kernel alone
    assert _read("launches_per_step.train", ctx) == 4


def test_idle_share_and_mfu():
    ctx = _ctx()
    busy_us = 2 * (100 + 300 + 50) + 400 + 10  # the dropped record's time is not seen
    assert ctx.trace.busy_s() == pytest.approx(busy_us / 1e6)
    assert _read("device_idle_pct.train", ctx) == pytest.approx(100 * (1 - busy_us / 2000))
    flops = work.unit_flops("train", ctx.config)
    assert _read("step_mfu.train", ctx) == pytest.approx(100 * flops * 2 / (0.002 * work.PEAK_FLOPS_F32))


def test_window_metrics_read_device_records_alone():
    """The window traced with CUDA activity alone has no host records: its
    length is the host clock's, its busy time the device records' union,
    and the optimizer's kernels are told from the stretch traced with host
    activity."""
    full = _ctx()
    device_only = Trace([e for e in _events() if e["cat"] in DEVICE_CATS], units=2, host_window_s=0.004)
    ctx = ReadContext(device_only, full.window, full.cell, full.kernel_names, host_trace=full.trace)
    assert device_only.window is None and device_only.window_s == 0.004
    assert ctx.trace.busy_s() == pytest.approx(full.trace.busy_s())
    assert _read("device_idle_pct.train", ctx) == pytest.approx(100 * (1 - full.trace.busy_s() / 0.004))
    assert _read("launches_per_step.train", ctx) == 4
    assert _read("optimizer_ms.train", ctx) == pytest.approx(0.05)
    assert _read("torch_ops_ms.train", ctx) == pytest.approx(0.1)
    assert _read("optimizer_ms.train", ReadContext(device_only, full.window, full.cell, full.kernel_names)) is None


def test_readers_find_nothing_and_return_nothing():
    ctx = _ctx()
    assert _read("k5_roofline", ctx) is None  # no K5 kernel in the trace
    empty = ReadContext(Trace([], units=2, host_window_s=0.002), ctx.window, ctx.cell, ctx.kernel_names)
    for name in ("k4_roofline", "torch_ops_ms.train", "optimizer_ms.train", "launches_per_step.train",
                 "device_idle_pct.train", "serve_roofline"):
        assert _read(name, empty) is None, name
    assert _read("serve_host_ms", empty) is None


def test_serve_readers():
    ctx = _ctx("mlp_serve_256", host_s=[0.001, 0.003, 0.002])
    assert _read("serve_host_ms", ctx) == pytest.approx(2.0)
    least_ms = work.least_time_s(*work.kernel_work("grid_forward", ctx.config)) * 1e3
    assert _read("serve_roofline", ctx) == pytest.approx(100 * least_ms / (0.1 + 0.3 + 0.4 + 0.05))


def test_breakdown():
    tr = _ctx().trace
    ops = tr.device_ops()
    assert ops[0] == [K4, pytest.approx(600e-6)]
    assert len(ops) == 5
    names = dict(tr.idle_gaps())
    # the gap after Adam's kernel in step 1 (860-1000 us) lies inside portbench.step's range until 900 us,
    # after it in none
    assert set(names) <= {"portbench.step", "(no host range)", "aten::mm", "cudaLaunchKernel"}
    assert math.isclose(sum(names.values()), 0.002 - tr.busy_s(), rel_tol=1e-9)
