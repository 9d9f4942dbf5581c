"""Grid serving: the port's serve path, `models.sample.grid_infer_any`, under
no_grad, one client, closed loop. A request asks for the whole grid's
field [nz, ny, nx, 4] at a time t drawn uniform in [t_low, t_high] from
the seed; it runs from the call until a synchronise finds its field
complete on the device. The field stays on the device.

The check: `check_requests` of the window's requests, drawn from the seed
(a reservoir sample over the window), held to the reference's field once
the window has closed.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time

import torch

from portbench.core import compare, inputs, program
from portbench.core.window import Window
from portbench.reference import train as ref
from portbench.reference.grid import Grid
from portbench.reference.precision import CONTROL, REFERENCE


class Job:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.grid = Grid(**cell.config["grid"])
        self.cells = self.grid.num_cells
        self.t_rng = random.Random(f"{seed}:t")
        self.keep_rng = random.Random(f"{seed}:keep")

    def _next_t(self) -> float:
        return self.t_rng.uniform(self.traffic["t_low"], self.traffic["t_high"])

    def setup(self) -> None:
        from phys_autodiff_tpu_torch.models.sample import grid_infer_any

        t0 = time.perf_counter()
        self.params = inputs.make_params(self.config, self.seed, self.device)
        g, model = program.grid_spec(self.config), program.model_config(self.config)

        def serve(t):
            with torch.no_grad():
                return grid_infer_any(g, model, self.params, t)

        self.serve = serve
        t1 = time.perf_counter()
        for _ in range(self.traffic["warm_requests"]):
            serve(self._next_t())
        self._sync()
        self.phases = {"inputs and program": t1 - t0, "warm requests": time.perf_counter() - t1}
        self.sample, self.seen = [], 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _keep(self, t: float, out) -> None:
        """Reservoir sampling of the window's requests."""
        self.seen += 1
        k = self.traffic["check_requests"]
        if len(self.sample) < k:
            self.sample.append((t, out))
        else:
            j = self.keep_rng.randrange(self.seen)
            if j < k:
                self.sample[j] = (t, out)

    def window(self, seconds: float | None = None, count: int | None = None, span=contextlib.nullcontext) -> Window:
        lat, host = [], []
        n = 0
        t0 = time.perf_counter()
        while (n < count) if count is not None else (time.perf_counter() - t0 < seconds):
            t = self._next_t()
            with span("portbench.request"):
                c0 = time.perf_counter()
                out = self.serve(t)
                c1 = time.perf_counter()
                self._sync()
                c2 = time.perf_counter()
            lat.append(c2 - c0)
            host.append(c1 - c0)
            n += 1
            self._keep(t, out)
            del out
        return Window(units=n, attempted=n, failed=0, window_s=time.perf_counter() - t0, latencies_s=lat,
                      host_s=host)

    def end_to_end(self, w: Window) -> dict:
        lat = sorted(w.latencies_s)
        p95 = lat[max(0, -(-95 * len(lat) // 100) - 1)]
        return {"serve_Mcells_per_s": self.cells * w.units / w.window_s / 1e6, "serve_p95_ms": p95 * 1e3}

    def release(self) -> None:
        del self.serve
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, kind: str = "program") -> dict:
        """field_err of the sampled requests ("program"), or of the
        reference in the control's arithmetic at their times ("control")."""
        truth_params = ref.cast(self.params, REFERENCE)
        gap = compare.FieldGap()
        for t, out in self.sample:
            judged = None
            if kind == "control":
                judged = ref.field_blocks(self.config, ref.cast(self.params, CONTROL), self.grid, t, CONTROL)
            elif kind != "program":
                raise ValueError(f"unknown check {kind!r}")
            for z0, z1, truth in ref.field_blocks(self.config, truth_params, self.grid, t, REFERENCE):
                gap.add(out[z0:z1] if judged is None else next(judged)[2], truth)
        return {"field_err": gap.value()}
