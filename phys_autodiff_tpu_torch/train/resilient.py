"""Checkpoint-every-K training with failure detection and auto-resume (port
of phys_autodiff_tpu/train/resilient.py).

A long run should not lose its work to one crashed worker, a lost
connection or a killed process. `fit_resilient` writes an atomic .npz
checkpoint (train/checkpoint.py) every `save_every` steps and, on a
failure that the predicate calls transient, rebuilds the step through the
user's factory and resumes from the newest checkpoint.

What the port must do differently from the JAX module:

  * A step updates the params and the optimizer state IN PLACE
    (train/loop.py: torch.optim's contract). A step that fails midway, say
    after `opt.step()` has moved some params, leaves the live state, and
    `state0` itself (the first step's input), half updated. So recovery
    reads the checkpoint file only: `state0` is just the `like` of
    checkpoint.restore_npz, which builds fresh tensors on like's devices
    and a fresh optimizer from like.opt's class and hyperparameters.
  * The checkpoint's host copy is save_npz's own (each leaf `.cpu()`): the
    JAX module's explicit device_get is not needed.
  * `TrainState.step` is a Python int; a state without `.step` (a plain
    dict of tensors) counts its steps in the checkpoint's manifest.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Callable

import torch

from phys_autodiff_tpu_torch.train import checkpoint

#: Messages of the sticky CUDA errors (cudaGetErrorString; the codes in
#: STICKY_CUDA_CODES): after one, every CUDA call of the process fails.
STICKY_CUDA_MESSAGES = (
    "an illegal memory access was encountered",  # 700
    "the launch timed out and was terminated",  # 702
    "device-side assert triggered",  # 710
    "hardware stack error",  # 714
    "an illegal instruction was encountered",  # 715
    "misaligned address",  # 716
    "operation not supported on global/shared address space",  # 717
    "invalid program counter",  # 718
    "unspecified launch failure",  # 719
    "uncorrectable ecc error encountered",  # 214
)
STICKY_CUDA_CODES = frozenset({214, 700, 702, 710, 714, 715, 716, 717, 718, 719})

#: Infrastructure-shaped message fragments: the JAX module's (a dead
#: worker, a lost connection: gloo's "Connection reset / closed by peer")
#: and torch.distributed's (an NCCL communicator aborted or timed out).
INFRA_MESSAGES = ("unavailable", "worker", "socket", "connection", "deadline", "crashed", "restarted",
                  "cancelled", "aborted", "timed out", "timeout")


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """True for a sticky CUDA error: kernels/_build.check's "...: CUDA error
    N (msg)", torch's "CUDA error: msg", or an exception whose `error_code`
    (torch.AcceleratorError) is one of STICKY_CUDA_CODES."""
    code = getattr(exc, "error_code", None)
    if code in STICKY_CUDA_CODES:
        return True
    msg = str(exc).lower()
    m = re.search(r"cuda error (\d+)", msg)
    if m and int(m.group(1)) in STICKY_CUDA_CODES:
        return True
    return any(s in msg for s in STICKY_CUDA_MESSAGES)


def default_failure_predicate(exc: Exception) -> bool:
    """True for exceptions that look like infrastructure failures (a worker
    crash or restart, a lost connection) rather than programming errors.

    The JAX module's rule: BOTH an infrastructure-shaped message
    (INFRA_MESSAGES) and a RuntimeError (torch.distributed's DistBackendError
    and DistNetworkError are). A bare RuntimeError("anything"), a ValueError
    or a utils/checks.CheckError re-raise at once: a retry would fail the
    same way and burn the restart budget. Two kinds are fatal whatever the
    message says:

      * torch.cuda.OutOfMemoryError: the same step at the same size runs
        out of memory again.
      * A sticky CUDA error (an illegal address 700, a launch timeout 702,
        a device-side assert 710, a hardware stack error, an illegal
        instruction, a misaligned address, an invalid PC 714-718, a launch
        failure 719, an uncorrectable ECC error 214): it leaves the
        process's CUDA context unusable, and no retry in the process can
        heal it. Restart the process; resume="auto" then continues from
        the checkpoint.

    An NCCL communicator that was aborted cannot be reused in the process:
    a factory for a sharded step must build its process group anew."""
    if isinstance(exc, torch.cuda.OutOfMemoryError) or is_sticky_cuda_error(exc):
        return False
    msg = str(exc).lower()
    return isinstance(exc, RuntimeError) and any(s in msg for s in INFRA_MESSAGES)


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    ckpt_path: str  # checkpoint file (".npz" appended if missing)
    save_every: int = 50  # optimizer steps between checkpoints
    max_restarts: int = 3  # give up after this many failures
    backoff_s: float = 0.0  # wait before a retry (worker recovery time)
    is_failure: Callable[[Exception], bool] = default_failure_predicate
    meta: dict | None = None  # embedded in every checkpoint (e.g.
    # ngp.checkpoint_meta(cfg)) and validated on resume


@dataclasses.dataclass
class RunReport:
    steps_done: int = 0
    failures: int = 0
    restores: int = 0
    checkpoints: int = 0


def fit_resilient(
    step_factory: Callable[[], Callable[[Any], tuple[Any, Any]]],
    state0: Any,
    steps: int,
    rcfg: ResilienceConfig,
    log: Callable[[int, float], None] | None = None,
    resume: str = "auto",
):
    """Run `steps` optimizer steps with checkpoint / auto-resume.

    step_factory() -> `step(state) -> (state, loss)` (e.g. the step of
    make_train_step or make_ngp_train_step); it is called once up front and
    AGAIN after every detected failure. state0 is the initial TrainState,
    or a (nested) dict / list / tuple of tensors; its structure defines the
    checkpoint format. The run updates state0's tensors in place.

    resume: "auto" (default) loads an existing checkpoint at ckpt_path and
    continues from it, so a process-level death (a sticky CUDA error, host
    OOM, SIGKILL) resumes by re-running the same command; "restart"
    overwrites it and starts from state0.

    On a failure, training resumes from the LAST CHECKPOINT (the steps since
    are re-done: at-least-once execution). The steps are deterministic and
    the generator that samples t lives in the state, so the trajectory is
    the uninterrupted one to the bit. The checkpoint write and the recovery
    itself run under the same failure handling as the steps; each recovery
    attempt spends one unit of the restart budget. The loss is read on the
    host once a burst, where device errors surface.

    Returns (final_state, history, report); history holds (step, loss)
    pairs at every checkpoint boundary."""
    if steps <= 0:
        return state0, [], RunReport()
    if resume not in ("auto", "restart"):
        raise ValueError(f"unknown resume mode {resume!r}")
    save_every = max(1, rcfg.save_every)

    def step_no(s, fallback):
        # a TrainState's count of updates; a plain dict has none
        n = getattr(s, "step", None)
        return fallback if n is None else int(n)

    report = RunReport()
    history: list[tuple[int, float]] = []
    base = step_no(state0, 0)
    npz = rcfg.ckpt_path if rcfg.ckpt_path.endswith(".npz") else rcfg.ckpt_path + ".npz"

    def reload_state(default):
        """Last checkpoint -> (state, done); `default` when none exists. The
        completed-step count comes from the manifest's extra["fit_done"]
        (written with every save), else from the state's step."""
        if not os.path.exists(npz):
            return default, 0
        s = checkpoint.restore_npz(rcfg.ckpt_path, state0, expect_meta=rcfg.meta)
        extra = (checkpoint.read_manifest(npz) or {}).get("extra") or {}
        if "fit_done" in extra:
            return s, max(0, int(extra["fit_done"]))
        return s, max(0, step_no(s, 0) - base)

    def save_ckpt(s, done_now):
        checkpoint.save_npz(rcfg.ckpt_path, s, meta=rcfg.meta, extra={"fit_done": int(done_now)})
        report.checkpoints += 1

    def spend_failure(exc):
        if not rcfg.is_failure(exc):
            raise exc
        report.failures += 1
        if report.failures > rcfg.max_restarts:
            raise RuntimeError(
                f"giving up after {report.failures - 1} restarts (max_restarts={rcfg.max_restarts})"
            ) from exc
        if rcfg.backoff_s:
            time.sleep(rcfg.backoff_s)

    if resume == "auto":
        state, done = reload_state(state0)
        if done:
            report.restores += 1
    else:
        state, done = state0, 0
    step = step_factory()
    recovering = False
    while True:
        try:
            if recovering:
                # from the file only: the live state may be half updated
                state, done = reload_state(state0)
                step = step_factory()
                report.restores += 1
                recovering = False
            if done == 0 and report.checkpoints == 0:
                save_ckpt(state, done)  # so that the first failure can resume
            if done >= steps:
                break
            burst = min(save_every, steps - done)
            for _ in range(burst):
                state, loss = step(state)
            loss_f = float(loss)  # the burst's one host read
            save_ckpt(state, done + burst)
        except Exception as exc:  # noqa: BLE001 (filtered by the predicate)
            spend_failure(exc)
            recovering = True
            continue
        done += burst
        history.append((step_no(state, done), loss_f))
        if log:
            log(step_no(state, done), loss_f)
    report.steps_done = done
    return state, history, report
