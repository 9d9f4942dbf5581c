"""The host's share of the main path's short calls on one card, for holding
two trees against each other.

    python -m phys_autodiff_tpu_torch.kernels.launch_cost [--label NAME] [--iters N] [--rounds N]

Each case is a call whose device work is short, so that the Python of the
kernel wrappers (the launch loop, kernels/_build.check, the launch counts)
shows in its time: K8's transport step at 128x96x96 (C = 1, one launch;
C = 5, two launches; the slab at nz_local 24, C = 3 self-advection), the
f32 K3 forward loss (mega_loss_pipeline, H = 128, seed 777, t = 0.25) and
one f32 MLP training step through K4 (make_train_step, use_fused, Adam).
For each it takes `rounds` rounds, each the CUDA-event median of `iters`
calls (utils/timing.cuda_time_ms) and the host wall time a call (mean over
`iters` calls between two synchronisations), and prints the median and the
least of the rounds. The host shares its cores, so one round of a case can
move by a third between two runs of the same tree. Then the host time of
one `kernels/_build.check` call as a wrapper makes it after a launch (with
the kernel's name and outputs where the tree's check takes them), the mean
of 10^5 calls. Last, one JSON line with every number and the card's name
and power limit. No `checked` call is active: this is the cost that the
numerical guards' hook adds to every launch.

It runs in a `git archive` of another commit too (copy this file into its
phys_autodiff_tpu_torch/kernels/ and run it from that tree's root, each
tree in its own process): parent, change, change, parent in one chip call
compares two trees on one card. Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np


def _cases(dev):
    """(name, fn) of each timed call."""
    import torch

    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import mega as kmega
    from phys_autodiff_tpu_torch.kernels import transport as ktr
    from phys_autodiff_tpu_torch.models import mlp
    from phys_autodiff_tpu_torch.ops.stencil import z_rows
    from phys_autodiff_tpu_torch.train import TrainConfig, make_train_step, state_from_params

    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    rng = np.random.default_rng(0)
    sigma = torch.tensor(rng.normal(size=g.shape).astype(np.float32), device=dev)
    u = torch.tensor((rng.uniform(-0.8, 0.8, size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None]
                      / g.dt).astype(np.float32), device=dev)
    five = torch.cat([sigma[None], u, 0.5 * sigma[None]])
    u_ext = u[:, z_rows(g, 23, 49, dev)].contiguous()  # rows 24 .. 47 with their halo planes
    w, cfg = PhysWeights(), MLPGridConfig(dims=MLPDims(H=128))
    params = mlp.init_params(cfg.dims, seed=777, device=dev)
    scfg = TrainConfig(learning_rate=1e-3, seed=777, t=0.25, use_fused=True)
    state, step = state_from_params(scfg, params), make_train_step(g, w, cfg, scfg)
    return (
        ("K8 transport C=1", lambda: ktr.transport_step_fused(g, sigma, u, g.dt)),
        ("K8 transport C=5 (2 launches)", lambda: ktr.transport_step_many_fused(g, five, u, g.dt)),
        ("K8 slab nz_local 24 C=3 self", lambda: ktr.transport_step_slab(g, u_ext, u_ext, g.dt)),
        ("K3 f32 loss", lambda: kmega.mega_loss_pipeline(g, w, cfg, params, 0.25)),
        ("K4 f32 train step", lambda: step(state)),
    )


def _wall_ms(fn, iters: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _check_ns(n: int = 100_000) -> float:
    """Host ns of one _build.check call after a successful launch, as K3's
    wrapper makes it: with the kernel's name and outputs where the check
    takes them (the guards' hook), else without."""
    import inspect

    import torch

    from phys_autodiff_tpu_torch.kernels import _build

    out = torch.empty(4, device="cuda")
    hook = "kernel" in inspect.signature(_build.check).parameters
    call = (lambda: _build.check(0, "mega kernel (f32)", "K3", (out,))) if hook else \
        (lambda: _build.check(0, "mega kernel (f32)"))
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    return (time.perf_counter() - t0) / n * 1e9


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from phys_autodiff_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("launch_cost needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rows = {}
    for name, fn in _cases(torch.device("cuda")):
        events, wall = [], []
        for _ in range(args.rounds):
            events.append(cuda_time_ms(fn, warmup=10, iters=args.iters))
            wall.append(_wall_ms(fn, args.iters))
        rows[name] = {"events_ms": events, "wall_ms": wall}
        print(f"launch_cost {args.label}: {name:32s} events {statistics.median(events):.5f} ms (median of "
              f"{args.rounds} rounds' medians of {args.iters}; least {min(events):.5f}), host wall a call "
              f"{statistics.median(wall):.5f} ms (least {min(wall):.5f})")
    check_ns = _check_ns()
    print(f"launch_cost {args.label}: one _build.check after a launch {check_ns:.1f} ns (host, mean of 10^5)")
    print(json.dumps({"label": args.label, "card": smi, "iters": args.iters, "cases": rows, "check_ns": check_ns}))


if __name__ == "__main__":
    main()
