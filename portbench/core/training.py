"""The loop of a training cell: one step object, built once, driven from the
seed through the checked steps and a warm-up in set-up, then through the
window. The loss is read to the host every `read_every` steps (as the
port's `fit` loop reads it every `log_every`); the steps between are
dispatched ahead.

A loop module subclasses TrainingJob with the entry point it drives
(`build_program`) and the loss its reference takes (`reference_loss`).
"""

from __future__ import annotations

import contextlib
import gc
import math
import time

import torch

from portbench.core import compare, inputs
from portbench.core.window import Window
from portbench.reference import train as ref
from portbench.reference.grid import Grid
from portbench.reference.precision import CONTROL, REFERENCE

#: Adam's first-moment decay in the program's optimizer (torch.optim.Adam).
BETA1 = 0.9


class TrainingJob:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell.config, cell.traffic
        self.grid = Grid(**cell.config["grid"])
        self.cells = self.grid.num_cells

    # -- the program -------------------------------------------------------

    def build_program(self):
        """(step, state): the entry point's step(state) -> (state, loss)."""
        raise NotImplementedError

    def reference_loss(self, params, k: int, prec, keep: float):
        """(loss, grads) of the reference at checked step k."""
        raise NotImplementedError

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.params0 = inputs.make_params(self.config, self.seed, self.device)
        self.step, self.state = self.build_program()
        t1 = time.perf_counter()
        losses = []
        p0 = dict(ref.flatten(self.params0))
        for k in range(self.traffic["checked_steps"]):
            self.state, loss = self.step(self.state)
            losses.append(loss.detach())
            if k == 0:  # a parameter the optimizer never moved has no moment: a gradient of 0
                opt = self.state.opt.state
                self.grad1 = [(path, opt[p]["exp_avg"].detach().double() / (1.0 - BETA1) if "exp_avg" in opt.get(p, {})
                               else torch.zeros_like(p, dtype=torch.float64))
                              for path, p in ref.flatten(self.state.params)]
                # Only its norm is compared: a leaf's norm stands for the leaf.
                self.change1 = [(path, torch.linalg.vector_norm(p.detach().double() - p0[path].double()))
                                for path, p in ref.flatten(self.state.params)]
        self.change = [(path, p.detach().double() - p0[path].double()) for path, p in ref.flatten(self.state.params)]
        self.losses = losses
        t2 = time.perf_counter()
        for _ in range(self.traffic["warm_steps"]):
            self.state, loss = self.step(self.state)
        float(loss)
        self.phases = {"inputs and program": t1 - t0, "checked steps": t2 - t1, "warm steps": time.perf_counter() - t2}

    def window(self, seconds: float | None = None, count: int | None = None, span=contextlib.nullcontext) -> Window:
        """Steps until `seconds` have passed (checked at each loss read) or
        `count` steps (a multiple of read_every) are done."""
        every = self.traffic["read_every"]
        n = bad = 0
        t0 = time.perf_counter()
        while True:
            with span("portbench.step"):
                self.state, loss = self.step(self.state)
            n += 1
            if n % every == 0:
                with span("portbench.read"):
                    if not math.isfinite(float(loss)):
                        bad += 1
                if (n >= count) if count is not None else (time.perf_counter() - t0 >= seconds):
                    break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Window(units=n, attempted=n, failed=bad, window_s=time.perf_counter() - t0)

    def end_to_end(self, w: Window) -> dict:
        return {"train_Mcells_per_s": self.cells * w.units / w.window_s / 1e6}

    def release(self) -> None:
        """Keep the program's outputs to judge; free its state."""
        self.judged = {"losses": [float(x) for x in self.losses], "grad1": self.grad1, "change": self.change,
                       "change1": self.change1}
        del self.step, self.state, self.losses
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def _trajectory(self, prec, keep: float = 1.0) -> dict:
        return ref.trajectory(
            self.config, self.params0, self.grid, self.config["weights"], self.traffic["learning_rate"],
            self.traffic["checked_steps"], prec, lambda p, k: self.reference_loss(p, k, prec, keep))

    def check(self, kind: str = "program") -> dict:
        """The compared numbers of the program ("program"), or of what the
        calibration puts in its place: the reference in the control's
        arithmetic ("control") or the reference over half of the grid, the
        mean taken over the rest ("half")."""
        truth = self._trajectory(REFERENCE)
        if kind == "program":
            judged = self.judged
        elif kind == "control":
            judged = self._trajectory(CONTROL)
        elif kind == "half":
            judged = self._trajectory(REFERENCE, keep=0.5)
        else:
            raise ValueError(f"unknown check {kind!r}")
        self.detail = compare.leaf_gaps(judged, truth)
        return compare.training(judged, truth)
