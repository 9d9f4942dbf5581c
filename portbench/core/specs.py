"""What a run reads: the cell's entry in BENCHMARK.json, and the files it
names, each found by name.

    configs/<name>.json    a model configuration (sizes, grid, precision)
    traffic/<name>.json    a traffic mix: the loop it runs and its parameters
    limits/<cell>.json     each compared number's limit in that cell
    metrics/<name>.py      the reader of one per-layer metric
    loops/<name>.py        the loop that drives one kind of entry point
    families/<name>.py     a model family's side of the port: its configuration
                           object, weights, training step and least work
    reference/<name>.py    the same family's plain reference

A later cell, metric or model family is added as files and BENCHMARK.json
entries alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str, pkg: Path = PKG) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files (under
    pkg, the benchmark's folder)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text())
    limits_file = pkg / "limits" / f"{workload}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic, limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str, pkg: Path = PKG):
    return load_module(pkg / "loops" / f"{name}.py", f"portbench_loop_{name}")


def metric_reader(name: str, pkg: Path = PKG):
    """The `read(ctx) -> float | None` of metrics/<name>.py."""
    return load_module(pkg / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_")).read


def family(name: str, pkg: Path = PKG):
    """The model family `name` (a configuration's "family"): families/<name>.py,
    whose `model_config`, `make_params`, `train_step`, `params_count`,
    `kernel_work` and `unit_flops` the harness calls, beside
    reference/<name>.py, the plain reference of the same model."""
    port, ref = pkg / "families" / f"{name}.py", pkg / "reference" / f"{name}.py"
    if not (port.is_file() and ref.is_file()):
        raise FileNotFoundError(f"no model family {name!r}: looked for {port} and {ref}")
    return load_module(port, f"portbench_family_{name}")
