"""A cell, a configuration, a traffic mix and a per-layer metric added as new
files and BENCHMARK.json entries are found by name; no file already there
changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

from portbench.tests.conftest import ROOT, SMALL

_RUN = """
import io, json, sys, time, torch
sys.path.insert(0, {root!r})
sys.path.append({repo!r})  # the program
from portbench.core import harness, specs
assert str(specs.PKG).startswith({root!r}), specs.PKG
cell = specs.load_cell(specs.PKG.parent, "mlp64_train_every5")
out = io.StringIO()
code = harness.run_cell(cell, 2, 0.1, True, torch.device("cpu"), time.perf_counter(), out=out, err=io.StringIO())
print(out.getvalue().strip().splitlines()[-1])
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "portbench")
    pkg = tmp_path / "portbench"

    config = json.loads((pkg / "configs" / "mlp_h128.json").read_text())
    config["dims"]["H"] = 64
    config["grid"].update(SMALL)
    (pkg / "configs" / "mlp_h64.json").write_text(json.dumps(config))
    traffic = json.loads((pkg / "traffic" / "train_uniform.json").read_text())
    traffic.update(read_every=5, trace_units=10)
    (pkg / "traffic" / "train_every5.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "traced_steps.py").write_text("def read(ctx):\n    return ctx.window.units\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mlp_h64", "source": "https://arxiv.org/abs/1711.10561",
                             "file": "portbench/configs/mlp_h64.json", "reduced": ["dims"], "why": "a test"})
    bench["workloads"].append({"name": "mlp64_train_every5", "config": "mlp_h64", "traffic": "train_every5",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "traced_steps", "unit": "count", "better": "higher", "source": "host_clock",
                               "layer": "train loop", "moves": "train_Mcells_per_s",
                               "workloads": ["mlp64_train_every5"]})
    bench["end_to_end"][0]["workloads"].append("mlp64_train_every5")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = subprocess.run([sys.executable, "-c", _RUN.format(root=str(tmp_path), repo=str(ROOT))], capture_output=True, text=True,
                          cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["metrics"]["traced_steps"]["value"] == 10
    assert res["attempted"] == 10
    after = _digests(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
