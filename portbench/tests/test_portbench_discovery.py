"""A cell, a configuration, a traffic mix, a per-layer metric and a model
family added as new files and BENCHMARK.json entries are found by name; no
file already there changes."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from portbench.core import specs
from portbench.tests.conftest import ROOT, SMALL, SMALL_MAX_RESOLUTION

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


def _copy(tmp_path):
    """A copy of the benchmark in tmp_path: (its folder, its files' digests)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path / "portbench", _digests(tmp_path / "portbench")


def test_new_files_are_found_by_name(tmp_path):
    pkg, before = _copy(tmp_path)

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


_RUN_FAMILY = """
import hashlib, io, json, sys, time, torch
sys.path.insert(0, {root!r})
sys.path.append({repo!r})  # the program
from portbench.core import harness, inputs, program, specs, work
from portbench.reference.train import flatten
assert str(specs.PKG).startswith({root!r}), specs.PKG
res = {{}}
for name in ("ngp_copy_fit", "ngp_small_fit"):
    cell = specs.load_cell(specs.PKG.parent, name)
    out = io.StringIO()
    code = harness.run_cell(cell, 2, 0.1, False, torch.device("cpu"), time.perf_counter(), out=out, err=io.StringIO())
    c = cell.config
    res[name] = {{
        "code": code, "result": json.loads(out.getvalue().strip().splitlines()[-1]),
        "model": repr(program.model_config(c)),
        "params": {{k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                    for k, v in flatten(inputs.make_params(c, 2, torch.device("cpu")))}},
        "counts": [work.params_count(c), [work.kernel_work(k, c) for k in ("K4", "K5", "K7", "grid_forward")],
                   [work.unit_flops(loop, c) for loop in ("train", "fit", "serve")]],
    }}
print(json.dumps(res))
"""


def test_a_model_family_is_new_files(tmp_path):
    """families/ngp_copy.py and reference/ngp_copy.py, copies of ngp's, a
    configuration that names the family and a cell on it: the cell runs,
    is correct, and gives the numbers of the same configuration under
    "ngp"."""
    pkg, before = _copy(tmp_path)
    shutil.copy(pkg / "families" / "ngp.py", pkg / "families" / "ngp_copy.py")
    shutil.copy(pkg / "reference" / "ngp.py", pkg / "reference" / "ngp_copy.py")
    config = json.loads((pkg / "configs" / "ngp_hash_l16.json").read_text())
    config["grid"].update(SMALL)
    config["encoding"]["max_resolution"] = SMALL_MAX_RESOLUTION
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for name, family in (("ngp_small", "ngp"), ("ngp_copy", "ngp_copy")):
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(dict(config, name=name, family=family)))
        shutil.copy(pkg / "limits" / "ngp_fit_256.json", pkg / "limits" / f"{name}_fit.json")
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2201.05989",
                                 "file": f"portbench/configs/{name}.json", "reduced": ["max_resolution"],
                                 "why": "a test"})
        bench["workloads"].append({"name": f"{name}_fit", "config": name, "traffic": "fit_snapshot", "chips": 1,
                                   "why": "a test"})
        bench["end_to_end"][0]["workloads"].append(f"{name}_fit")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    proc = subprocess.run([sys.executable, "-c", _RUN_FAMILY.format(root=str(tmp_path), repo=str(ROOT))],
                          capture_output=True, text=True, cwd=tmp_path, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    copy, ngp = res["ngp_copy_fit"], res["ngp_small_fit"]
    assert copy["code"] == 0 and copy["result"]["correct"], copy["result"]
    assert copy["result"]["checks"] == ngp["result"]["checks"]
    for key in ("model", "params", "counts"):
        assert copy[key] == ngp[key], key
    after = _digests(pkg)
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_family_names_the_files_looked_for():
    with pytest.raises(FileNotFoundError) as e:
        specs.family("no_such_family")
    for f in ("families/no_such_family.py", "reference/no_such_family.py"):
        assert f in str(e.value)
