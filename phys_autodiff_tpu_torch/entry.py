"""The flagship forward of the port and the multi-process dry run
(counterparts of __graft_entry__.entry and dryrun_multichip).

entry(device) -> (fn, example_args): the single-kernel forward
(mega_loss_pipeline: MLP -> fields -> residuals -> loss partials ->
deterministic sum) of the flagship model, H=128, seed 777, t=0.25, on a
128x64x64 grid, with its parameters on `device`.

dryrun_multichip(n) drives the z-sharded paths on n gloo processes of the
CPU (parallel/launch.run_gloo; the kernels' plain versions run there) and
prints the JAX dry run's "ok" lines: phase 1 the staged sharded step (the
1-D mesh), 2 the fused step's slab arm, 3 its K4 arm, 4 and 5 the sharded
NGP gradient (hash, Fourier), 9 and 9b the sharded composite fit (xla,
mega), 11 and 12 the bf16 NGP fit and gradient on the fast encode, 13 a
300-step sharded training run that must drop the loss by 90%. Run it as
`python -m phys_autodiff_tpu_torch.entry N`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels.mega import mega_loss_pipeline
from phys_autodiff_tpu_torch.models import mlp

GRID = GridSpec(nx=128, ny=64, nz=64, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
WEIGHTS = PhysWeights()
CONFIG = MLPGridConfig(dims=MLPDims(H=128))
SEED = 777
T = 0.25


def entry(device: torch.device):
    params = mlp.init_params(CONFIG.dims, seed=SEED, device=device)

    def forward(params):
        l_sigma, l_u = mega_loss_pipeline(GRID, WEIGHTS, CONFIG, params, T)
        return l_sigma + l_u

    return forward, (params,)


def _finite_norm(grads) -> float:
    from phys_autodiff_tpu_torch.utils import tree

    total = sum(float(torch.sum(torch.abs(x))) for x in tree.leaves(grads))
    assert np.isfinite(total) and total > 0.0, total
    return total


def _dryrun_rank(mesh) -> list[str]:
    """The dry run's phases on one rank; returns its "ok" lines."""
    from phys_autodiff_tpu_torch.kernels.fit import ngp_fit_loss_and_grad_sharded, pack_target
    from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_loss_and_grad_sharded
    from phys_autodiff_tpu_torch.models import ngp
    from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
    from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu_torch.parallel.mesh import shard_rows
    from phys_autodiff_tpu_torch.parallel.sharded import make_sharded_fused_train_step, make_sharded_train_step
    from phys_autodiff_tpu_torch.train import TrainConfig
    from phys_autodiff_tpu_torch.train import fit_field as ffd

    n, dev = mesh.size, mesh.device
    shape = f"{{'z': {n}}}"
    lines = []
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=32))

    def finite(x, what):
        assert np.isfinite(float(x)), f"non-finite {what} {float(x)}"
        return float(x)

    # Phase 1: the staged sharded step on the 1-D z mesh
    g = GridSpec(nx=16, ny=8, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    step, init = make_sharded_train_step(g, w, mcfg, mesh)
    _, loss = step(init(mlp.init_params(mcfg.dims, seed=0, device=dev)), 0.25)
    lines.append(f"dryrun_multichip ok: mesh={shape} loss={finite(loss, 'loss'):.6f} grid={g.shape}")

    # Phase 2: the fused step's slab arm (sz = 1)
    step, init = make_sharded_fused_train_step(g, w, mcfg, mesh, sz=1)
    _, loss = step(init(mlp.init_params(mcfg.dims, seed=0, device=dev)), 0.25)
    lines.append(f"dryrun_multichip fused ok: mesh={shape} loss={finite(loss, 'fused sharded loss'):.6f}")

    # Phase 3: its K4 arm, the shard-local build a rank
    g3 = GridSpec(nx=128, ny=8, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    step, init = make_sharded_fused_train_step(g3, w, mcfg, mesh, backward="mega")
    _, loss = step(init(mlp.init_params(mcfg.dims, seed=0, device=dev)), 0.25)
    lines.append(f"dryrun_multichip mega ok: mesh={shape} loss={finite(loss, 'sharded mega loss'):.6f}")

    # Phases 4 and 5: the sharded NGP gradient, hash and Fourier encodings
    enc_cfg = HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                                 dense_oversubscribed=True)
    ncfg = ngp.NGPFieldConfig(encoding=enc_cfg, hidden=16)
    nparams = ngp.init_ngp_params(ncfg, seed=0, device=dev)
    loss, (grads, _) = ngp_loss_and_grad_sharded(g3, w, ncfg, mesh)(nparams, 0.25)
    _finite_norm(grads)
    lines.append(f"dryrun_multichip ngp ok: mesh={shape} loss={finite(loss, 'sharded NGP loss'):.6f}")
    ncfg5 = ngp.NGPFieldConfig(encoding=FourierEncodingConfig(num_frequencies=3), hidden=16)
    loss, (grads, _) = ngp_loss_and_grad_sharded(g3, w, ncfg5, mesh)(ngp.init_ngp_params(ncfg5, seed=0, device=dev),
                                                                      0.25)
    _finite_norm(grads)
    lines.append(f"dryrun_multichip fourier ok: mesh={shape} loss={finite(loss, 'sharded Fourier loss'):.6f}")

    # Phases 9 and 9b: the sharded PINN composite fit, xla and mega engines
    rng = np.random.default_rng(9)
    tgt = ffd.FitTarget(torch.tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                        torch.tensor((0.3 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev), 0.25)
    losses = {}
    for engine in ("xla", "mega"):
        step, init = ffd.make_sharded_fit_step(g, mcfg, [tgt], mesh, TrainConfig(steps=1, learning_rate=1e-3),
                                               phys_weight=0.3, engine=engine)
        _, loss = step(init())
        losses[engine] = finite(loss, f"sharded fit loss ({engine})")
    assert abs(losses["mega"] - losses["xla"]) <= 1e-5 * max(1.0, abs(losses["xla"])), losses
    lines.append(f"dryrun_multichip fit ok: mesh={shape} loss={losses['xla']:.6f}")
    lines.append(f"dryrun_multichip fit-mega ok: mesh={shape} loss={losses['mega']:.6f}")

    # Phases 11 and 12: the bf16 NGP fit and gradient on the fast encode
    rng = np.random.default_rng(11)
    packed = pack_target(g3, torch.tensor(rng.uniform(size=g3.shape).astype(np.float32)),
                         torch.tensor((0.3 * rng.normal(size=(3,) + g3.shape)).astype(np.float32)))
    loss, (grads, _) = ngp_fit_loss_and_grad_sharded(g3, ncfg, mesh, precision="bf16")(
        nparams, shard_rows(mesh, packed), 0.25)
    _finite_norm(grads)
    lines.append(f"dryrun_multichip fit-ngp-fast-bf16 ok: mesh={shape} loss={finite(loss, 'fit loss'):.6f}")
    loss, (grads, _) = ngp_loss_and_grad_sharded(g3, w, ncfg, mesh, precision="bf16")(nparams, 0.25)
    _finite_norm(grads)
    lines.append(f"dryrun_multichip ngp-fast-bf16 ok: mesh={shape} loss={finite(loss, 'train loss'):.6f}")

    # Phase 13: 300 sharded training steps drop the loss by 90%
    g13 = GridSpec(nx=16, ny=16, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    step, init = make_sharded_train_step(g13, w, mcfg, mesh, learning_rate=3e-3)
    state = init(mlp.init_params(mcfg.dims, seed=1, device=dev))
    first = last = None
    for _ in range(300):
        state, loss = step(state, 0.25)
        last = float(loss)
        first = last if first is None else first
    assert np.isfinite(last) and last <= 0.1 * first, f"sharded training only dropped {first} -> {last}"
    lines.append(f"dryrun_multichip convergence ok: mesh={shape} loss {first:.4f} -> {last:.6f} "
                 f"({100 * (1 - last / first):.1f}% drop over 300 steps)")
    return lines


def dryrun_multichip(n_devices: int) -> list[str]:
    """The dry run on n_devices gloo processes of the CPU (see the module
    docstring); prints rank 0's "ok" lines and returns them. Every rank runs
    every phase; a failing phase raises."""
    from phys_autodiff_tpu_torch.parallel.launch import run_gloo

    lines = run_gloo(_dryrun_rank, n_devices)[0]
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
