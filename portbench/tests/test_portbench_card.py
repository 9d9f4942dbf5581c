"""A cell as a check runs it, on the card: one short run of the command."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_serve_cell_runs_correct_on_the_card(card, trace):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mlp_serve_256", "--seed", "2147483651", "--seconds", "2",
         "--trace", trace], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
