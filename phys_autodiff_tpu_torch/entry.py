"""The flagship forward of the port and the multi-process dry run
(counterparts of __graft_entry__.entry and dryrun_multichip).

entry(device) -> (fn, example_args): the single-kernel forward
(mega_loss_pipeline: MLP -> fields -> residuals -> loss partials ->
deterministic sum) of the flagship model, H=128, seed 777, t=0.25, on a
128x64x64 grid, with its parameters on `device`.

dryrun_multichip(n) drives the z-sharded paths on n gloo processes of the
CPU (parallel/launch.run_gloo; the kernels' plain versions run there) and
prints the JAX dry run's "ok" lines: phase 1 the staged sharded step (on the
2-D (z, h) mesh, z n/2 by h 2, where n is even and above 2, else the 1-D
mesh), 2 the fused step's slab arm, 3 its K4 arm, 4 and 5 the sharded NGP
gradient (hash, Fourier), 6 particle advection split over the ranks, 7 the
z-sharded transport, 8 the sharded Euler rollout (MacCormack, confinement,
viscosity, diffusivity, the pencil FFT projection), 9 and 9b the sharded
composite fit (xla, mega), 10 the sharded Euler rollout with a solid
obstacle and sources (the masked CGNR projection on the shards), 11 and 12
the bf16 NGP fit and gradient on the fast encode, 13 a 300-step sharded
training run that must drop the loss by 90%. Run it as
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
    from phys_autodiff_tpu_torch.apps import advect as adv
    from phys_autodiff_tpu_torch.apps import euler as eu
    from phys_autodiff_tpu_torch.apps import transport as tr
    from phys_autodiff_tpu_torch.ops import obstacles as obs
    from phys_autodiff_tpu_torch.parallel.mesh import make_mesh_2d, shard_rows
    from phys_autodiff_tpu_torch.parallel.sharded import (
        make_sharded_fused_train_step,
        make_sharded_train_step,
        make_sharded_train_step_2d,
    )
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

    # Phase 1: the staged sharded step, on the 2-D (z, h) mesh where n is
    # even and above 2, else on the 1-D z mesh
    if n % 2 == 0 and n > 2:
        mesh2 = make_mesh_2d(2, device=dev)
        g1 = GridSpec(nx=16, ny=8, nz=2 * mesh2.z.size, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
        step, init = make_sharded_train_step_2d(g1, w, mcfg, mesh2)
        shape1 = "{" + ", ".join(f"'{k}': {v}" for k, v in mesh2.shape.items()) + "}"
    else:
        g1 = GridSpec(nx=16, ny=8, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
        step, init = make_sharded_train_step(g1, w, mcfg, mesh)
        shape1 = shape
    _, loss = step(init(mlp.init_params(mcfg.dims, seed=0, device=dev)), 0.25)
    lines.append(f"dryrun_multichip ok: mesh={shape1} loss={finite(loss, 'loss'):.6f} grid={g1.shape}")

    # Phase 2: the fused step's slab arm (sz = 1)
    g = GridSpec(nx=16, ny=8, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
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

    # Phase 6: particle advection, the particles split over the ranks, the
    # model replicated, no collective
    vel = adv.velocity_fn_from_model(g, mcfg, mlp.init_params(mcfg.dims, seed=0, device=dev))
    pts0 = torch.tensor((np.random.default_rng(0).uniform(size=(8 * n, 3)) * [g.nx, g.ny, g.nz]).astype(np.float32))
    final = mesh.all_gather(adv.advect_sharded(g, vel, pts0, 0.0, adv.AdvectConfig(steps=5, dt=1e-2), mesh), 0)
    assert bool(torch.isfinite(final).all()) and float(torch.max(final[:, 0])) < g.nx
    lines.append(f"dryrun_multichip advect ok: mesh={shape} particles={pts0.shape[0]}")

    # Phase 7: the z-sharded transport (halo planes exchanged, K8's slab form)
    rng = np.random.default_rng(7)
    sigma = torch.tensor(rng.normal(size=g.shape).astype(np.float32))
    u = torch.tensor((rng.uniform(-0.8, 0.8, size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None]
                      / 1e-2).astype(np.float32))
    out, cfl = tr.transport_sharded(g, shard_rows(mesh, sigma), shard_rows(mesh, u, 1),
                                    tr.TransportConfig(dt=1e-2, steps=4), mesh)
    assert bool(torch.isfinite(out).all()) and float(cfl) <= 1.0
    lines.append(f"dryrun_multichip transport ok: mesh={shape} cfl={float(cfl):.3f}")

    # Phase 8: the sharded Euler rollout (MacCormack, buoyancy, confinement,
    # viscosity, diffusivity, the pencil FFT projection)
    g8 = GridSpec(nx=16, ny=2 * n, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    rng = np.random.default_rng(8)
    state = eu.EulerState(torch.tensor(rng.uniform(size=g8.shape).astype(np.float32)),
                          torch.tensor((0.5 * rng.normal(size=(3,) + g8.shape)).astype(np.float32)))
    cfg8 = eu.EulerConfig(dt=0.05, steps=3, buoyancy=0.5, viscosity=0.05, diffusivity=0.02, advection="maccormack",
                          confinement=1.0)
    final8, diag8 = eu.rollout_sharded(g8, eu.EulerState(shard_rows(mesh, state.sigma), shard_rows(mesh, state.u, 1)),
                                       cfg8, mesh)
    assert bool(torch.isfinite(final8.sigma).all()) and bool(torch.isfinite(final8.u).all())
    umax = float(mesh.all_reduce(torch.max(torch.abs(final8.u)), op=torch.distributed.ReduceOp.MAX)) + 1e-30
    dmax = float(torch.max(diag8["max_abs_div"]))
    assert dmax <= 1e-4 * max(umax, 1.0), (dmax, umax)
    lines.append(f"dryrun_multichip euler ok: mesh={shape} max|div|={dmax:.2e}")

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

    # Phase 10: the sharded Euler rollout with a solid box and sources (the
    # masked CGNR projection on the shards)
    g10 = GridSpec(nx=16, ny=8, nz=2 * n, hx=0.4, hy=0.4, hz=0.4, dt=1e-2)
    mask = obs.box_mask(g10, (n // 2, 2, 4), (n + 2, 6, 12), device="cpu")
    rate, force = torch.zeros(g10.shape), torch.zeros((3,) + g10.shape)
    rate[1, 1:4, 1:4] = 2.0
    force[2, 1, 1:4, 1:4] = 0.5
    rng = np.random.default_rng(10)
    sigma = torch.tensor(np.abs(rng.normal(size=g10.shape)).astype(np.float32))
    u = 0.3 * torch.tensor(rng.normal(size=(3,) + g10.shape).astype(np.float32))
    mask_l = shard_rows(mesh, mask)
    final10, _ = eu.rollout_sharded(g10, eu.EulerState(shard_rows(mesh, sigma), shard_rows(mesh, u, 1)),
                                    eu.EulerConfig(dt=0.05, steps=3, buoyancy=1.0, cg_maxiter=20), mesh, mask=mask_l,
                                    source=eu.EulerSource(shard_rows(mesh, rate), shard_rows(mesh, force, 1)))
    assert bool(torch.isfinite(final10.sigma).all()) and bool(torch.isfinite(final10.u).all())
    solid = mask_l == 0.0
    assert bool((final10.u[:, solid] == 0.0).all()) and bool((final10.sigma[solid] == 0.0).all())
    sigma_sum = float(mesh.chain_sum(torch.sum(final10.sigma)))
    lines.append(f"dryrun_multichip euler-obstacle-source ok: mesh={shape} sigma_sum={sigma_sum:.4f}")

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
