"""One run of one cell:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

set-up (the weights from the seed on the card, the program's objects, the
checked steps and a warm-up of the cell's own shapes), then the window:
with --trace 0 for `--seconds` seconds, reporting the cell's end-to-end
metrics; with --trace 1 a fixed count of units under torch.profiler with
CUDA activity alone (a host-activity profiler would pace a step of many
launches itself), then a short stretch with host activity as well, which
attributes kernels to the host code that launched them, reporting its
per-layer metrics. Then the program's state is freed and the reference
judges what the timed path produced. The last line of standard
output is one JSON object; the numbers compared, each beside its limit,
are the last lines of standard error and the result's last key.

No result is printed, and the exit code is not 0, where there is no CUDA
device or fewer than the cell asks for, where the program cannot be
imported, or where jax, jaxlib, flax or phys_autodiff_tpu (by whole
top-level module name) is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

from portbench.core import program, specs
from portbench.core.trace import WINDOW, Trace, kernel_base_name

#: Top-level modules that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "phys_autodiff_tpu")


def forbidden_modules(modules=None) -> list[str]:
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Refused(Exception):
    """A run that may print no result."""


class ReadContext:
    """What a per-layer metric's reader reads: the trace of the window
    (`trace`: device records alone), the stretch traced with host activity
    too (`host_trace`: which host range launched each kernel), the
    harness's own host timings, the configuration and the traffic."""

    def __init__(self, trace, window, cell, kernel_names, host_trace=None):
        self.trace, self.window, self.cell = trace, window, cell
        self.host_trace = trace if host_trace is None else host_trace
        self.config, self.traffic = cell.config, cell.traffic
        self.kernel_names = kernel_names  # the program's csrc kernels

    def is_program_kernel(self, rec) -> bool:
        return kernel_base_name(rec.name) in self.kernel_names

    def kernels_named(self, names):
        names = frozenset(names)
        return lambda rec: kernel_base_name(rec.name) in names


def _device_info(device, peak: int | None) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak or 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1, "memory_peak_bytes": peak}


#: Units of the stretch traced with host activity.
ATTRIBUTION_UNITS = 10


def _profiled(job, acts, count: int, span):
    """`count` units under torch.profiler with the activities `acts`;
    (Window, the trace's events)."""
    import torch
    from torch.profiler import profile, record_function

    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            w = job.window(count=count, span=span)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    if job.device.type == "cuda":
        torch.cuda.synchronize(job.device)
    return w, events


def _traced_window(job, count: int):
    """The window of `count` units with CUDA activity alone, then a stretch
    of ATTRIBUTION_UNITS units (or the next whole read) with host activity
    too; (Window, events, the stretch's units, its events). On the CPU both
    are host traces."""
    from torch.profiler import ProfilerActivity, record_function

    cuda = job.device.type == "cuda"
    device = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    host = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # A first profiled stretch, thrown away, so that the profiler's own
    # start (CUPTI's first records) falls outside the traced window.
    _profiled(job, device, ATTRIBUTION_UNITS, contextlib.nullcontext)
    w, events = _profiled(job, device, count, contextlib.nullcontext)
    hw, host_events = _profiled(job, host, ATTRIBUTION_UNITS, record_function)
    return w, events, hw.units, host_events


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float, check: str = "program",
             out=sys.stdout, err=sys.stderr) -> int:
    """Run the cell once on `device` and print its result. `check` names
    what the reference judges (calibrate.py's controls and faults; a run
    judges the program). Returns the exit code."""
    import torch

    loop = specs.loop(cell.traffic["loop"])
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": _device_info(device, None)}
    numbers, code = {}, 1
    try:
        job = loop.Job(cell, seed, device)
        t_job = time.perf_counter()
        job.setup()
        setup_s = time.perf_counter() - t0
        phases = {"start to set-up": t_job - t0, **getattr(job, "phases", {})}
        print("set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()), file=err)
        if trace:
            w, events, host_units, host_events = _traced_window(job, cell.traffic["trace_units"])
        else:
            w = job.window(seconds=seconds)
        found = forbidden_modules()
        if found:
            raise Refused(f"loaded once the window closed: {', '.join(found)}")
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
        result["device"] = _device_info(device, peak)
        result["attempted"], result["failed"] = w.attempted, w.failed
        metrics = {}
        if trace:
            tr, host_tr = Trace(events, w.units, w.window_s), Trace(host_events, host_units)
            del events, host_events
            result["device"]["busy_s"] = tr.busy_s()
            result["device"]["window_s"] = tr.window_s
            ctx = ReadContext(tr, w, cell, program.kernel_names(), host_tr)
            for m in cell.per_layer:
                value = specs.metric_reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            # The idle gaps, named by what the host was doing, come from the
            # stretch traced with host activity (its own seconds).
            result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": host_tr.idle_gaps()}
            if tr.dropped():
                print(f"profiler records not a whole number a unit: {', '.join(tr.dropped()[:5])}", file=err)
        else:
            measured = dict(job.end_to_end(w), setup_s=setup_s)
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
        result["metrics"] = metrics
        job.release()
        numbers = job.check(check)
        for k, v in getattr(job, "detail", {}).items():
            print(f"leaf {k} {v}", file=err)
        # A cell holds the numbers its limits name (each has to be there),
        # and a cell with none is not correct.
        result["correct"] = (w.failed == 0 and bool(cell.limits)
                             and all(numbers[k] <= v for k, v in cell.limits.items()))
        code = 0
    except Refused as e:
        print(f"refused: {e}", file=err)
        return 3
    except Exception:
        traceback.print_exc(file=err)
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return code


def main(argv, t0: float, root: Path) -> int:
    args = parse(argv)
    cell = specs.load_cell(root, args.workload)
    try:
        import torch
    except ImportError as e:
        print(f"no torch: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {cell.chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    try:
        import phys_autodiff_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t0)
