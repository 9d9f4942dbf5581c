"""The result line: one JSON object on every path that may print one, none
where a run may not, and the whole-name check for JAX."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench.core import harness
from portbench.tests.conftest import CELLS, ROOT, small_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def _run(cell, trace=False, seed=3):
    out, err = io.StringIO(), io.StringIO()
    code = harness.run_cell(cell, seed, 0.2, trace, torch.device("cpu"), time.perf_counter(), out=out, err=err)
    return code, out.getvalue(), err.getvalue()


def _last_json(text: str) -> dict:
    lines = text.strip().splitlines()
    assert lines, "no result line"
    return json.loads(lines[-1])


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_one_json_object_last(name, trace):
    cell = small_cell(name)
    code, out, err = _run(cell, trace)
    res = _last_json(out)
    assert code == 0
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    # each compared number is also one of the last lines of standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


@pytest.mark.parametrize("limits,correct", [
    ({}, False),
    ({"loss_gap": 1.0, "grad_gap": 1.0, "change1_gap": 1.0}, True),
    ({"loss_gap": 1.0, "grad_gap": 1.0, "change1_gap": 1.0, "change_gap": -1.0}, False),
])
def test_a_cell_holds_the_numbers_its_limits_name(limits, correct):
    """The numbers a cell's limits name decide `correct`; another is printed
    with no limit; a cell with no limits is not correct."""
    cell = small_cell("mlp_train_256")
    cell.limits = limits
    res = _last_json(_run(cell)[1])
    assert res["correct"] is correct
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap", "change1_gap"}
    assert all(res["checks"][k]["limit"] == limits.get(k) for k in res["checks"])


def test_a_failing_run_still_prints_its_result(monkeypatch):
    cell = small_cell("mlp_train_256")
    from portbench.core.training import TrainingJob

    def broken(self):
        raise RuntimeError("set-up failed")

    monkeypatch.setattr(TrainingJob, "setup", broken)
    code, out, err = _run(cell)
    res = _last_json(out)
    assert code != 0 and res["correct"] is False
    assert all(k in res for k in KEYS)
    assert "set-up failed" in err


def test_no_result_when_a_forbidden_module_is_loaded(monkeypatch):
    monkeypatch.setattr(harness, "forbidden_modules", lambda modules=None: ["jax"])
    code, out, err = _run(small_cell("mlp_serve_256"))
    assert code != 0 and out == ""
    assert "jax" in err


def test_forbidden_names_are_whole_top_level_names():
    mods = ["phys_autodiff_tpu_torch", "phys_autodiff_tpu_torch.kernels", "jaxtyping", "flaxen", "torch"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy", "phys_autodiff_tpu.models"]) == ["jax", "phys_autodiff_tpu"]


def test_a_machine_without_cuda_fails_and_prints_no_result():
    """On this CPU-only machine the command itself refuses to run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", "mlp_train_256", "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
