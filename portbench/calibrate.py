"""The readings the limits of `correct` are set from, for one cell, in one
process on the card:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 4,5,6] [--half 7,8,9] [--seconds 1]

For each seed of --seeds a short run of the program, judged as a run
judges it (the lower readings); for each of --control the reference in
the control's arithmetic (float32 with TF32 matmuls) put in the program's
place; for each of --half the reference over half of the grid, the mean
taken over the rest (training cells). Prints one JSON line a run:
{"kind", "seed", "checks", "correct"}, then the largest program reading and
the smallest of the others for each number.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from portbench.core import harness, specs  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--half", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = specs.load_cell(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    readings = {}
    for kind, seeds in (("program", args.seeds), ("control", args.control), ("half", args.half)):
        for seed in _seeds(seeds):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            harness.run_cell(cell, seed, args.seconds, False, dev, t0, check=kind, out=out, err=err)
            lines = out.getvalue().strip().splitlines()
            if not lines:
                print(err.getvalue()[-4000:], file=sys.stderr)
                continue
            res = json.loads(lines[-1])
            checks = {k: v["value"] for k, v in res.get("checks", {}).items()}
            if not checks:
                print(err.getvalue()[-4000:], file=sys.stderr)
            for k, v in checks.items():
                readings.setdefault((kind, k), []).append(v)
            leaves = {}  # "leaf <grad1|change> <path> <program norm> <reference norm>"
            for line in err.getvalue().splitlines():
                if line.startswith("leaf "):
                    name, a, b = line[5:].rsplit(" ", 2)
                    leaves[name] = [float(a), float(b)]
            print(json.dumps({"kind": kind, "seed": seed, "checks": checks, "correct": res["correct"],
                              "metrics": res["metrics"], "s": round(time.perf_counter() - t0, 2),
                              "leaves": leaves}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    summary = {f"{kind} {k}": (max(v) if kind == "program" else min(v)) for (kind, k), v in readings.items()}
    print(json.dumps({"summary": summary, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
