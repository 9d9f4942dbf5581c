"""Run a function on every rank of a gloo group of CPU processes: how the
sharded paths run on one host without cards (the tests and
entry.dryrun_multichip).

`run_gloo(fn, size, *args)` starts `size` processes, each of which
joins a gloo group through a file store in a temporary directory (no
network), builds the CPU z mesh and returns fn(mesh, *args); it returns
the ranks' results in rank order, or raises with the first failing rank's
traceback. fn must be importable (a module-level function) and its
arguments and result picklable.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import traceback

import torch
import torch.distributed as dist

from phys_autodiff_tpu_torch.parallel.mesh import make_mesh


#: How long a rank waits on a collective, and the parent on a rank's result.
TIMEOUT_S = 600.0


def _worker(fn, rank: int, size: int, store: str, args, out) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            out.put((rank, "ok", fn(make_mesh(device="cpu"), *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the parent re-raises it with the rank's traceback
        out.put((rank, "error", traceback.format_exc()))


def run_gloo(fn, size: int, *args) -> list:
    """fn(mesh, *args) on each of `size` gloo ranks (CPU processes); the
    results in rank order."""
    # The ranks fork from a server process that imported fn's module once
    # (forkserver), rather than each importing it afresh (seconds apiece).
    ctx = mp.get_context("forkserver")
    if fn.__module__ != "__main__":
        ctx.set_forkserver_preload(["torch", fn.__module__])
    out = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_worker, args=(fn, r, size, store, args, out), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            for _ in range(size):
                rank, status, value = out.get(timeout=TIMEOUT_S)
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
        except queue_mod.Empty:
            errors.append(f"no result within {TIMEOUT_S} s")
        finally:
            for p in procs:
                p.join(timeout=5 if not errors else 0.1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    if errors:
        raise RuntimeError("a gloo rank failed: " + errors[0])
    return [results[r] for r in range(size)]
