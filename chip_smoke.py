#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phys_autodiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. device   require CUDA; print the card's name and power limit
  2. build    build the kernels from csrc/ (nvcc, sm_90a) and time it
  3. parity   first one bf16 mma.sync fragment's packing against
              torch.bfloat16's bits; then each kernel vs its plain PyTorch version on the card, at the
              main path's shapes and at small ragged grids (both schemes,
              both boundaries, nz=1, nz=2), with the tolerance beside each
              error; the autograd gradients of K2 -> K1 and K3 against plain
              autograd; K5 (the NGP backward) at the NGP flagship and at small
              grids, hash-only and Fourier encodings included, and at the
              edges of the head core's tiling (LF 4, 33, 64; H 8 and the
              largest the gate takes), for K5 and K7, against its
              referee (float32 forward, float64 backward) and, looser,
              float32 autograd; the hash grid encoder's kernel pair
              (csrc/hash_encode.cu) against its plain ops at ngp_hash_l16
              and NGPFieldConfig(), 128x96x96, a ragged grid and 256^3, f32
              and fast, forward and pull-back, the pull-back repeated to the
              bit and the rows form equal to the whole encode's rows; K6
              and K7 (the supervised-fit kernels) at the
              fit flagship (128x96x96, H=128 and NGPFieldConfig()) and at
              small grids against their referees and float32 autograd; K2
              (both layouts and S = 1), K3 (against its plain version and
              K2 -> K1, printing whether the two losses are equal to the
              bit), K4 and K6 at the edges of the tiled MLP core (H 4, 33,
              100, 200, 512 and the largest each gate takes; nx 7-40 with
              ragged ny; nz 1-17 and 150, more tile rows than blocks); K8
              (the semi-Lagrangian step, C = 1-5 with C = 3 both u itself
              and other scalars, +-dt), K8c (the step from six weight
              planes) and P1 (the launch-floor probe) bitwise against their
              plain versions, at 128x96x96, at the edges of K8's walk
              (ragged tiles, nx below the tile and not a multiple of 4, nz
              1-3 and above the ring and a z chunk, more tiles than a wave)
              and K8 C = 1 and K8c at 256^3, both boundaries; the bf16 tier
              (K2 bf16 and bf16x3, K3, K4, K6) against its plain bf16
              versions at the flagship and at the core's edges with the
              bf16 gates' tops, K3 bf16 = K2 bf16 -> K1 to the bit, and
              each bf16 kernel apart from its f32 kernel; the NGP path's
              reduced tiers (K5 bf16 and f32_fastbwd, K7 bf16) against
              their plain versions at the flagship (the fast encode for
              bf16) and at the head core's edges (LF, H at 1, 4k -+ 1 and
              the gate's top; K7 bf16 also without dEnc), the fastbwd loss
              equal to f32 K5's to the bit; the outputs of the kernels that
              K4 bf16's and K7 bf16's redesign leaves alone (K4 bf16's loss,
              f32 K4, K2 bf16 / bf16x3, K3 bf16, K6, K5 in every tier, f32
              K7) at kernels/tier_bench's fixed inputs held to the digests
              recorded for the tree before that redesign, and K4 bf16's loss
              equal to K2 bf16 -> K1's to the bit;
              K1's bf16-I/O entry points bitwise equal to the f32
              kernel rounded, at most 1 bf16 ulp from their plain versions;
              the z-sharded path: the shard-local builds of K4 (f32, bf16),
              K5 (f32, bf16, f32_fastbwd), K6 and K7 (f32, bf16) on every
              shard of the 2- and 4-way splits of 128x96x96 (both
              boundaries; K4 / K5 also a ragged upwind clamp grid) against
              their referees or plain versions, the shards' sum against the
              whole-grid kernel (the loss and the owned rows' outputs
              printed bitwise), the sharded steps over a world-size-1 NCCL
              group against the single-device steps, and F12 (the fused
              step at H = 1400, past K4's gate, against the plain step);
              K8's slab form (the sharded transport's kernel) on every
              shard of the 2-, 4- and 8-way splits of 128x96x96, both
              boundaries, C = 1, 3 and the self-advection, +-dt, its halo
              planes the neighbouring rows: bitwise the whole-grid K8 and
              its plain twin; then over the world-size-1 NCCL group
              transport_sharded (both schemes, both boundaries) bitwise
              transport, project_fft_sharded within 1e-6 of project_fft,
              rollout_sharded (MacCormack, confinement, viscosity,
              diffusivity) within 1e-5 of rollout, the masked rollout with
              sources (the masked CGNR on the shards) within 1e-5 of the
              masked rollout, the generic sharded step and the 2-D step on
              a 1 x 1 (z, h) mesh against the single-device staged steps;
              "checks": utils/checks.checked around the K3 and K2 -> K1
              losses (None on the flagship; with a NaN in one W2 entry,
              the kernel that first wrote a NaN named) and a 5-channel K8
              step (a NaN in its last channel named K8)
  4. slice    the forward slice end to end at 128x96x96, H=128, seed 777,
              t=0.25 through the user entry points (README quick start,
              fused_loss_pipeline, mega_loss_pipeline, entry(), the bench
              headline op), launch counts of every kernel (K2 and K3 once a
              call), agreement of the arms, the loss against the float64
              oracle, K3 run twice (bitwise equal) and K2's S = 1 output
              against the t slice of its S = 3 output (bitwise); then the
              training slice: fit() for 5 adam steps with use_fused=True
              (K4 once per step) against the same steps by plain autograd,
              the 5 K4 steps and 5 MLP fit steps through K6 each run twice
              from one seed (bitwise-equal losses and params), and
              loss_fn(use_fused=True) (K3 forward, K4 backward); then
              the encoded-field slice: 5 adam steps of
              make_ngp_train_step(backward="mega") at NGPFieldConfig() on
              128x96x96 (K5 once per step) against 5 plain-autograd steps,
              run twice from one seed (bitwise-equal losses and params),
              and one make_generic_train_step(physics_loss="fused") step (K1);
              then the fit -> serve round trip through the CLI (cli.main):
              the flagship target written with utils/export, `fit` for 5
              steps per family with --engine mega (K6 / K7 once per step)
              and --engine xla, `serve` on the grid and at 2^17 points,
              `export`, and one --phys-weight step per family (K6 + K4,
              K7 + K5); then the transport and Euler paths: 100-step
              frozen-u rollouts at 128x96x96 (semi-Lagrangian, MacCormack,
              the weights form: K8 / K8c once or twice a step), a
              time-dependent rollout driven by the fitted MLP, and
              `simulate` at 128x96x96 (K8 4 times a MacCormack step, 2 a
              semi-Lagrangian one; the final frame against the plain
              rollout) and from the fitted checkpoint on a small clamp grid
              with a sphere obstacle (masked CGNR); the bf16 slice:
              grid_infer_fused bf16 and bf16x3 (one launch each), both
              forward losses in bf16 (equal to the bit), 5 K4-bf16 training
              steps and 5 K6-bf16 fit steps, each run twice (bitwise) and
              held step by step to the plain bf16 steps; loss_fn(use_fused)
              in bf16 (K3 bf16 forward, K4 bf16 backward) against K4 bf16's
              gradients, and 2 composite bf16 fit steps (phys_weight 0.1:
              K6 and K4 bf16 once a step each) run twice (bitwise) and held
              to the plain bf16 composite; the NGP tiers: 5 steps each of
              make_ngp_train_step(precision="bf16" and "f32_fastbwd",
              backward="mega") (the tier's K5 once a step), 5 NGP
              fit_field steps in bf16 (K7 bf16) and 5 composite ones (K7
              and K5 bf16), each run twice (bitwise) and held step by step
              to the plain tier; K1's bf16-I/O entry points on the NGP's
              packed fields (once each); `train` through the CLI where K5
              cannot take the head (Fourier LF = 69, H = 256): "auto" takes
              the xla arm, no K5 launch; the sharded entry points over the
              world-size-1 NCCL group with exact launch counts of the
              shard-local kernels (counters "mega_bwd shard", ...); the
              sharded transport and Euler paths there (100-step
              transport_sharded per scheme, 4-step rollout_sharded per
              scheme, 2 masked steps) with exact counts of K8's slab form
              ("transport slab": 1 or 2 a transport step, 2 or 4 an Euler
              step) and no whole-grid "transport" launch; "resilient K4" /
              "resilient K5": train/resilient.fit_resilient over the flagship
              K4 training step (12 steps, a crash injected at the 7th call:
              13 K4 launches) and the NGP K5 step (6 steps, a crash at the
              4th: 7 launches), each bitwise the uninterrupted run, a resume
              to 14 K4 steps (2 launches, bitwise), assert_all_finite on
              the trained params and the checkpoint save's wall ms
  5. times    CUDA-event medians of each kernel and its plain version, and
              each kernel's own device time from a torch.profiler trace
              (K2's to K7's launches split out beside their bounds, and K3
              beside K2 -> K1's partials);
              one training step through K4 and one through K5 against
              plain-autograd steps; the encoder forward + pull-back; K6,
              K7 and one fit step of each family through each engine; K8
              (C = 1, 3, and C = 1 at 256^3 with its GB/s), K8c, P1, their
              event ms less device ms (the wrappers' host cost), K8's
              launches beside their bounds ("phase 5 split transport"), and
              one Euler step per advection scheme; the bf16 kernels beside
              their plain bf16 versions, one bf16 training step and one
              bf16 fit step, their launches split beside their bounds
              (bytes, CUDA-core operations and tensor-core FLOP); the same
              for the NGP tiers' kernels and steps and K1's bf16 I/O, and
              the registers and spills ptxas reports for the bf16 kernels of
              K3-K7 (none spills at the flagship's instantiation); the
              shard-local builds at nz_local 48 and 24 beside their plain
              versions, the world-size-1 sharded step, and F12's step;
              K8's slab form at nz_local 48 and 24 beside its plain twin
              and its bound, one sharded transport step and one sharded
              Euler step (MacCormack) over the world-size-1 group beside
              the single-device ones; "trace": one K4 training step under
              utils/timing.trace in annotate("train_step") (the exported
              trace holds the annotation and K4's kernels inside it), the
              trace's overhead, and the checked K3 loss beside the
              unchecked one
Then one JSON line of per-kernel results (with each kernel's bound: the
least time the card could take for its work) and, last, the result line
{"ok": true, "device": {...}}.

The port imports torch and never jax, nor the JAX package; neither does
this script. Weights are random (seeded), as the port's init functions
draw them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def transport_field(g, device, seed=0, cfl=0.8):
    """scripts/transport_bench.py's field: sigma ~ N(0, 1) and a frozen random
    velocity whose offsets reach +-cfl cells."""
    rng = np.random.default_rng(seed)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (rng.uniform(-cfl, cfl, size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None]
         / g.dt).astype(np.float32)
    return torch.tensor(sigma, device=device), torch.tensor(u, device=device)


@contextlib.contextmanager
def plain_transport():
    """K8's and K8c's wrappers replaced by their plain versions, so that a
    rollout on the card runs the referee's steps. Checks that nothing was
    launched inside (a caller that bound a wrapper by name would launch K8
    and hold it against itself); the launch counts outside are kept."""
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import transport as ktr

    saved = ktr.transport_step_many_fused, ktr.transport_step_fused_pre
    counts = dict(_build.LAUNCHES)
    _build.reset_launches()
    ktr.transport_step_many_fused = lambda g, f, u, dt: ktr.transport_step_many_plain(g, f, u, dt)
    ktr.transport_step_fused_pre = ktr.transport_pre_plain
    try:
        yield
        inside = {k: v for k, v in _build.LAUNCHES.items() if v}
        check(not inside, f"the plain reference run launched no kernel (it launched {inside})")
    finally:
        ktr.transport_step_many_fused, ktr.transport_step_fused_pre = saved
        _build.LAUNCHES.update(counts)


def read_vtk(path, g):
    """(sigma [nz, ny, nx], u [3, nz, ny, nx]) from a utils/export.write_vtk file."""
    with open(path, "rb") as f:
        data = f.read()
    n = g.num_cells
    i = data.index(b"LOOKUP_TABLE default\n") + len(b"LOOKUP_TABLE default\n")
    j = data.index(b"VECTORS u float\n") + len(b"VECTORS u float\n")
    sigma = np.frombuffer(data, ">f4", n, i).reshape(g.shape).astype(np.float32)
    u = np.moveaxis(np.frombuffer(data, ">f4", 3 * n, j).reshape(g.shape + (3,)), -1, 0).astype(np.float32)
    return sigma, u


def transport_channels(sigma, u):
    """K8's channel sets: (tag, fields). C = 3 twice: u itself (the Euler
    self-advection, which the kernel serves from the fields' slot rows
    alone) and three other scalars; C = 5 takes two launches (4 + 1)."""
    return (("C=1", sigma[None]), ("C=2", torch.stack([sigma, u[0]])), ("C=3 self", u),
            ("C=3", torch.stack([sigma, u[0], u[1]])), ("C=4", torch.cat([sigma[None], u])),
            ("C=5", torch.cat([sigma[None], u, 0.5 * sigma[None]])))


def transport_parity(report, dev, flagship, small, big):
    """Phase 3 for K8, K8c and P1: each against its plain version on the card,
    bitwise (the kernels round every operation in the plain version's order).
    K8 at `flagship` (the transport-bench field, CFL 0.8) and at `small`
    grids (the edges of the kernel's walk: ragged x and y tiles, nx below
    the 32-column tile and not a multiple of 4, ny below and above the
    8-row tile, nz 1 and 2 and below and above the ring's depth and a z
    chunk, more tiles than a wave of blocks), every channel set of
    transport_channels, +dt and -dt (MacCormack's two passes); at `big`
    (256^3, beyond L2) C = 1 at +-dt. K8c at every grid. Both boundaries
    throughout. One line a case at the flagship, one a grid elsewhere (the
    largest error of its cases). Returns the flagship's max abs errors (K8,
    K8c, P1)."""
    from phys_autodiff_tpu_torch.kernels import probe as kprobe
    from phys_autodiff_tpu_torch.kernels import transport as ktr

    def err(a, b):
        return float((a - b).abs().max())

    worst = [0.0, 0.0]
    for g in [*flagship, *small, *big]:
        tag = f"{g.nx}x{g.ny}x{g.nz} {'periodic' if g.periodic else 'clamp'}"
        sigma, u = transport_field(g, dev)
        sets = transport_channels(sigma, u)[:1] if g in big else transport_channels(sigma, u)
        errs = []
        for what, fields in sets:
            for dt in (g.dt, -g.dt):
                e = err(ktr.transport_step_many_fused(g, fields, u, dt),
                        ktr.transport_step_many_plain(g, fields, u, dt))
                errs.append(e)
                if g in flagship:
                    report("transport", f"{tag} {what} dt={dt:+.0e}", e, 0.0, "max_abs")
                    worst[0] = max(worst[0], e)
        if g not in flagship:
            report("transport", f"{tag} {', '.join(w for w, _ in sets)}, dt=+-{g.dt:.0e}", max(errs), 0.0,
                   "max_abs")
        w8 = ktr.transport_weights(g, u, g.dt)
        e = err(ktr.transport_step_fused_pre(g, sigma, w8), ktr.transport_pre_plain(g, sigma, w8))
        report("transport", f"{tag} K8c weights form", e, 0.0, "max_abs")
        if g in flagship:
            worst[1] = max(worst[1], e)
        del sigma, u, sets, w8
    x = torch.randn(96, 128, device=dev)
    e_probe = err(kprobe.probe(x), kprobe.probe_plain(x))
    report("probe", "[96, 128] x + 1", e_probe, 0.0, "max_abs")
    return worst[0], worst[1], e_probe


def slab_of(g, x, z0, nzl):
    """Planes z0 - 1 .. z0 + nzl of x [C, nz, ny, nx] under g's z rule: a
    shard's rows with the neighbouring rows as its halo planes (a clamped
    grid's edge plane copied)."""
    from phys_autodiff_tpu_torch.ops.stencil import z_rows

    return x[:, z_rows(g, z0 - 1, z0 + nzl + 1, x.device)].contiguous()


def transport_slab_parity(report, dev, grids, splits=(2, 4, 8)):
    """Phase 3 for K8's slab form: on every shard of the 2-, 4- and 8-way z
    splits of each grid, one shard after another in one process, its halo
    planes taken from the neighbouring rows: C = 1, C = 3 (three scalars)
    and the self-advection (u itself), +dt and -dt (MacCormack's passes).
    Each shard's output must be bitwise the whole-grid K8's rows and bitwise
    its plain twin (the plain step on the slab's nz_local + 2 planes).
    Returns the largest max abs error of the slab kernel against either."""
    from phys_autodiff_tpu_torch.kernels import transport as ktr

    worst = 0.0
    for g in grids:
        sigma, u = transport_field(g, dev)
        for what, fields in (("C=1", sigma[None]), ("C=3", torch.stack([sigma, u[0], u[1]])), ("C=3 self", u)):
            errs = []
            for dt in (g.dt, -g.dt):
                whole = ktr.transport_step_many_fused(g, fields, u, dt)
                for n in splits:
                    nzl = g.nz // n
                    for r in range(n):
                        u_ext = slab_of(g, u, r * nzl, nzl)
                        f_ext = u_ext if fields is u else slab_of(g, fields, r * nzl, nzl)
                        out = ktr.transport_step_slab(g, f_ext, u_ext, dt)
                        errs.append(float((out - whole[:, r * nzl:(r + 1) * nzl]).abs().max()))
                        errs.append(float((out - ktr.transport_step_slab_plain(g, f_ext, u_ext, dt)).abs().max()))
            tag = f"{g.nx}x{g.ny}x{g.nz} {'periodic' if g.periodic else 'clamp'} {what}"
            report("transport slab", f"{tag}, every shard of the {', '.join(map(str, splits))}-way splits, dt=+-"
                   f"{g.dt:.0e}: vs the whole-grid K8 and the plain slab step", max(errs), 0.0, "max_abs")
            worst = max(worst, max(errs))
        del sigma, u
    return worst


def sharded_apps_parity(check, dev, g, t):
    """Phase 3: the sharded apps over the world-size-1 NCCL group against
    their single-device entry points on the card: transport_sharded (both
    schemes, both boundaries) bitwise transport's result; project_fft_sharded
    within 1e-6 of project_fft (relative L2; the pencil's FFT order);
    rollout_sharded (MacCormack, buoyancy, confinement, viscosity,
    diffusivity) within 1e-5 of rollout (tests/test_spectral.py's class),
    and the gradient in the initial state of a semi-Lagrangian rollout
    (buoyancy, confinement, viscosity, diffusivity, a mean flow of 2 added
    to u) and of transport_sharded (both schemes) within 1e-5 relative L2 of
    the single-device gradient, the backward through K8's slab step, the
    halo's and the all-to-all's adjoints. (MacCormack's clip and
    confinement's normalisation make the gradient discontinuous or
    ill-conditioned at a few cells where the velocity or the vorticity
    gradient nears zero: there the pencil FFT's rounding moves a 3-step
    gradient by up to 7e-4 relative L2 at this grid, from 6 to 464 cells of
    1.2M; the mean flow keeps u off zero.) The masked rollout with sources (phase 10's, the masked CGNR on the
    shards) within 1e-5 of rollout with the mask; the generic sharded step
    (the MLP's fields as a generic generator) and the 2-D step on a 1 x 1
    (z, h) mesh within 5e-6 on the loss and 1e-6 relative L2 on every
    parameter of the single-device staged steps."""
    from phys_autodiff_tpu_torch import MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.apps import euler
    from phys_autodiff_tpu_torch.apps import transport as tr
    from phys_autodiff_tpu_torch.models import fields as fields_mod
    from phys_autodiff_tpu_torch.models import mlp
    from phys_autodiff_tpu_torch.ops import obstacles, projection
    from phys_autodiff_tpu_torch.parallel import sharded as sh
    from phys_autodiff_tpu_torch.parallel.mesh import make_mesh_2d
    from phys_autodiff_tpu_torch.parallel.spectral import project_fft_sharded
    from phys_autodiff_tpu_torch.train import TrainConfig, make_generic_train_step, make_train_step, state_from_params
    from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

    mesh = world_of_one(dev)
    for periodic in (True, False):
        gt = dataclasses.replace(g, periodic=periodic)
        sigma, u = transport_field(gt, dev)
        for scheme in ("semi_lagrangian", "maccormack"):
            cfg = tr.TransportConfig(dt=gt.dt, steps=10, scheme=scheme)
            out_n, cfl_n = tr.transport_sharded(gt, sigma, u, cfg, mesh)
            out_1, cfl_1 = tr.transport(gt, sigma, u, cfg)
            same = torch.equal(out_n, out_1) and torch.equal(cfl_n, cfl_1)
            print(f"phase 3 sharded transport {scheme} {'periodic' if periodic else 'clamp'} (1 rank, 10 steps): "
                  f"bitwise equal to transport {same}")
            check(same, f"transport_sharded ({scheme}) is transport's result to the bit")
    rng = np.random.default_rng(3)
    u = torch.tensor(rng.normal(size=(3,) + g.shape).astype(np.float32), device=dev)
    e = rel_l2_err(host(project_fft_sharded(g, u, mesh)), host(projection.project_fft(g, u)))
    print(f"phase 3 sharded project_fft (1 rank): rel_l2 {e:.2e} <= 1e-06")
    check(e <= 1e-6, "project_fft_sharded is project_fft")
    st = euler.EulerState(torch.tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                          torch.tensor((0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev))
    ecfg = euler.EulerConfig(dt=2e-3, steps=3, buoyancy=0.5, viscosity=0.05, diffusivity=0.02,
                             advection="maccormack", confinement=1.0)
    with torch.no_grad():
        fn, dn = euler.rollout_sharded(g, st, ecfg, mesh)
        f1, d1 = euler.rollout(g, st, ecfg)
    errs = [rel_l2_err(host(fn.sigma), host(f1.sigma)), rel_l2_err(host(fn.u), host(f1.u)),
            float(torch.max(torch.abs(dn["kinetic_energy"] / d1["kinetic_energy"] - 1))),
            float(torch.max(torch.abs(dn["max_cfl"] / d1["max_cfl"] - 1)))]
    print(f"phase 3 sharded rollout (1 rank, MacCormack, confinement, viscosity, diffusivity, 3 steps): rel_l2 "
          f"sigma {errs[0]:.2e}, u {errs[1]:.2e}, kinetic energy {errs[2]:.2e}, max_cfl {errs[3]:.2e} (<= 1e-05); "
          f"max_abs_div {float(dn['max_abs_div'].max()):.2e}")
    check(max(errs) <= 1e-5, "rollout_sharded is rollout")
    wts = [torch.tensor(rng.normal(size=x.shape).astype(np.float32), device=dev) for x in st]

    def grad_of(run, inputs):
        leaves = [x.clone().requires_grad_() for x in inputs]
        loss = sum(torch.sum(wt * o) for wt, o in zip(wts, run(*leaves)))
        return torch.autograd.grad(loss, leaves)

    gcfg = dataclasses.replace(ecfg, advection="semi_lagrangian")
    for name, inputs, run_n, run_1 in (
            ("rollout", (st.sigma, st.u + 2.0),
             lambda s, v: euler.rollout_sharded(g, euler.EulerState(s, v), gcfg, mesh)[0],
             lambda s, v: euler.rollout(g, euler.EulerState(s, v), gcfg)[0]),
            *((f"transport {scheme}", tuple(st),
               lambda s, v, c=tr.TransportConfig(dt=g.dt, steps=4, scheme=scheme): (
                   tr.transport_sharded(g, s, v, c, mesh)[0],),
               lambda s, v, c=tr.TransportConfig(dt=g.dt, steps=4, scheme=scheme): (tr.transport(g, s, v, c)[0],))
              for scheme in ("semi_lagrangian", "maccormack"))):
        errs = [rel_l2_err(host(a), host(b)) for a, b in zip(grad_of(run_n, inputs), grad_of(run_1, inputs))]
        print(f"phase 3 sharded {name} gradient (1 rank{', semi-Lagrangian, mean flow 2' if name == 'rollout' else ''}): rel_l2 d/dsigma0 {errs[0]:.2e}, d/du0 {errs[1]:.2e} "
              f"(<= 1e-05)")
        check(max(errs) <= 1e-5, f"the sharded {name}'s gradient is the single-device one")
    mask = obstacles.box_mask(g, (g.nz // 4, g.ny // 4, g.nx // 4), (g.nz // 2, g.ny // 2, g.nx // 2), device=dev)
    rate = torch.zeros(g.shape, device=dev)
    rate[1, 1:8, 1:8] = 2.0
    force = torch.zeros((3,) + g.shape, device=dev)
    force[2, 1, 1:8, 1:8] = 0.5
    src = euler.EulerSource(rate, force)
    mcfg10 = euler.EulerConfig(dt=2e-3, steps=3, buoyancy=1.0, cg_maxiter=20)
    with torch.no_grad():
        fn, _ = euler.rollout_sharded(g, st, mcfg10, mesh, mask=mask, source=src)
        f1, _ = euler.rollout(g, st, mcfg10, mask=mask, source=src)
    errs = [rel_l2_err(host(fn.sigma), host(f1.sigma)), rel_l2_err(host(fn.u), host(f1.u))]
    solid = mask == 0.0
    print(f"phase 3 sharded masked rollout (1 rank, a solid box, sources, CGNR 20 iterations, 3 steps): rel_l2 "
          f"sigma {errs[0]:.2e}, u {errs[1]:.2e} (<= 1e-05); bitwise equal {torch.equal(fn.u, f1.u)}")
    check(max(errs) <= 1e-5 and bool((fn.u[:, solid] == 0).all()) and bool((fn.sigma[solid] == 0).all()),
          "the masked rollout_sharded is the masked rollout, zero in the solid")
    del st, fn, f1, u, mask, src

    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=128))
    p0 = mlp.init_params(mcfg.dims, seed=777, device=dev)

    def held(what, loss_n, params_n, loss_1, params_1):
        worst = max(rel_l2_err(host(params_n[k]), host(params_1[k])) for k in params_1)
        print(f"phase 3 sharded {what}: loss {float(loss_n):.9g} vs {float(loss_1):.9g} (rel {rel(loss_n, loss_1):.2e}"
              f" <= 5e-06), worst param rel_l2 {worst:.2e} (<= 1e-06)")
        check(rel(loss_n, loss_1) <= 5e-6 and worst <= 1e-6, f"the sharded {what} is the single-device one")

    gen = lambda p, tt: fields_mod.generate_fields(g, mcfg, p, tt, g.dt)  # noqa: E731
    step, init = sh.make_generic_sharded_train_step(g, w, gen, mesh, p0, 1e-3)
    sn, ln = step(init(), t)
    step1, s1 = make_generic_train_step(g, w, gen, TrainConfig(learning_rate=1e-3, t=t), p0, physics_loss="staged")
    s1, l1 = step1(s1)
    held("generic step (1 rank, the MLP's fields as the generator)", ln, sn.params, l1, s1.params)
    mesh2 = make_mesh_2d(1, device=dev)
    step, init = sh.make_sharded_train_step_2d(g, w, mcfg, mesh2, 1e-3)
    sn, ln = step(init(p0), t)
    tcfg = TrainConfig(learning_rate=1e-3, t=t)
    s1, l1 = make_train_step(g, w, mcfg, tcfg)(state_from_params(tcfg, p0))
    held("2-D step (a 1 x 1 (z, h) mesh)", ln, sh.gather_params_2d(mesh2, sn.params), l1, s1.params)
    torch.cuda.empty_cache()


def sharded_transport_slice(check, dev, g):
    """Phase 4: the sharded transport and Euler paths over the world-size-1
    NCCL group with exact launch counts of K8's slab form: 100 steps of
    transport_sharded per scheme (1 and 2 launches a step), 4 steps of
    rollout_sharded per scheme (the self-advection's and the density's
    passes: 2 and 4 a step) and phase 10's masked rollout (2 a step); no
    whole-grid K8 launch on any of them. Returns the slab launches of the
    run."""
    from phys_autodiff_tpu_torch.apps import euler
    from phys_autodiff_tpu_torch.apps import transport as tr
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.ops import obstacles

    mesh = world_of_one(dev)
    sigma, u = transport_field(g, dev)
    rng = np.random.default_rng(0)
    st = euler.EulerState(torch.tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                          torch.tensor((0.3 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev))
    mask = obstacles.box_mask(g, (g.nz // 4, g.ny // 4, g.nx // 4), (g.nz // 2, g.ny // 2, g.nx // 2), device=dev)
    expect = 0
    _build.reset_launches()
    with torch.no_grad():
        for scheme, per_step in (("semi_lagrangian", 1), ("maccormack", 2)):
            out, cfl = tr.transport_sharded(g, sigma, u, tr.TransportConfig(dt=g.dt, steps=100, scheme=scheme), mesh)
            check(bool(torch.isfinite(out).all()) and float(cfl) <= 1.0, f"transport_sharded ({scheme})")
            expect += 100 * per_step
            for steps, kw in ((4, {}), (2, {"mask": mask})):
                cfg = euler.EulerConfig(dt=2e-3, steps=steps, buoyancy=0.5, advection=scheme,
                                        confinement=0.0 if kw else 1.0)
                final, diag = euler.rollout_sharded(g, st, cfg, mesh, **kw)
                check(bool(torch.isfinite(final.u).all()) and bool(torch.isfinite(diag["max_abs_div"]).all()),
                      f"rollout_sharded ({scheme}{', masked' if kw else ''})")
                expect += steps * 2 * per_step
    torch.cuda.synchronize()
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"phase 4 sharded transport and Euler (1 rank): transport_sharded 100 steps a scheme, rollout_sharded 4 "
          f"steps a scheme and 2 masked: launches {got}")
    check(got == {"transport slab": expect}, f"K8's slab form {expect} times (1 or 2 a transport step, 2 or 4 an "
          f"Euler step) and no whole-grid K8 launch")
    return {"transport slab": got.get("transport slab", 0)}


def transport_slice(check, run_cli, dev, g, tmp, mlp_ckpt):
    """Phase 4 for K8 and K8c: the transport and Euler paths through their
    entry points with exact launch counts, each against the same run through
    the plain versions on the card. Returns the launch counts of the frozen-u
    rollouts {"transport": ..., "transport_pre": ...}."""
    from phys_autodiff_tpu_torch import GridSpec
    from phys_autodiff_tpu_torch.apps import euler
    from phys_autodiff_tpu_torch.apps import transport as tr
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import transport as ktr
    from phys_autodiff_tpu_torch.models import modelio

    def launched():
        torch.cuda.synchronize()
        return {k: v for k, v in _build.LAUNCHES.items() if v}

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    steps = 100
    sigma0, u = transport_field(g, dev)
    lo, hi = float(sigma0.min()), float(sigma0.max())
    counts = {}
    for scheme, per_step in (("semi_lagrangian", 1), ("maccormack", 2)):
        cfg = tr.TransportConfig(dt=g.dt, steps=steps, scheme=scheme)
        _build.reset_launches()
        out, cfl = tr.transport(g, sigma0, u, cfg)
        got = launched()
        with plain_transport():
            ref, _ = tr.transport(g, sigma0, u, cfg)
        e = float((out - ref).abs().max())
        print(f"phase 4 transport {scheme}: {steps} steps at {g.nx}x{g.ny}x{g.nz}, launches {got}, max CFL "
              f"{float(cfl):.4f}, sigma in [{float(out.min()):.6f}, {float(out.max()):.6f}] of [{lo:.6f}, {hi:.6f}], "
              f"vs the plain rollout max abs {e:.3e} (<= 1e-6)")
        check(got == {"transport": per_step * steps}, f"transport {scheme} launches K8 {per_step} times a step")
        check(float(out.min()) >= lo - 1e-6 and float(out.max()) <= hi + 1e-6, f"transport {scheme} max principle")
        check(e <= 1e-6, f"transport {scheme} vs plain")
        if scheme == "semi_lagrangian":
            counts["transport"] = got.get("transport", 0)
    w8 = ktr.transport_weights(g, u, g.dt)
    _build.reset_launches()
    s = sigma0
    for _ in range(steps):
        s = ktr.transport_step_fused_pre(g, s, w8)
    got = launched()
    s_ref = sigma0
    for _ in range(steps):
        s_ref = ktr.transport_pre_plain(g, s_ref, w8)
    e = float((s - s_ref).abs().max())
    print(f"phase 4 transport_step_fused_pre: {steps} steps, launches {got}, vs the plain rollout max abs {e:.3e} "
          f"(<= 1e-6)")
    check(got == {"transport_pre": steps} and e <= 1e-6, "K8c once a step, equal to its plain rollout")
    counts["transport_pre"] = got.get("transport_pre", 0)
    del u, w8, out, ref, s, s_ref

    # a time-dependent velocity from the fitted model of the CLI round trip
    gm, mcfg, params = modelio.load_model(mlp_ckpt, device=dev)
    td_steps = 20
    cfg = tr.TransportConfig(dt=gm.dt, steps=td_steps)
    with torch.no_grad():
        vel_at = tr.velocity_grid_fn_from_model(gm, mcfg, params)
        sig_m = sigma0
        _build.reset_launches()
        out, cfl = tr.transport_time_dependent(gm, sig_m, vel_at, 0.25, cfg)
        got = launched()
        with plain_transport():
            ref, _ = tr.transport_time_dependent(gm, sig_m, vel_at, 0.25, cfg)
    e = float((out - ref).abs().max())
    print(f"phase 4 transport_time_dependent (the fitted MLP's u, {td_steps} steps): launches {got}, max CFL "
          f"{float(cfl):.4f}, vs the plain rollout max abs {e:.3e} (<= 1e-6)")
    check(got == {"transport": td_steps} and e <= 1e-6 and bool(torch.isfinite(out).all()),
          "transport_time_dependent launches K8 once a step, equal to its plain rollout")

    # simulate at the flagship grid with the JAX CLI's defaults (MacCormack,
    # buoyancy 0.5): K8 four times a step, the final frame equal to the same
    # rollout through the plain versions
    frames, per_frame = 2, 4
    prefix = os.path.join(tmp, "sim", "roll")
    _build.reset_launches()
    out = run_cli(["simulate", "--grid", f"{g.nx}x{g.ny}x{g.nz}", "--frames", str(frames), "--steps-per-frame",
                   str(per_frame), "--out", prefix])
    got = launched()
    sig_k, u_k = read_vtk(f"{prefix}_{frames - 1:04d}.vtk", g)
    rng = np.random.default_rng(0)
    state = euler.EulerState(torch.tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                             torch.tensor((0.3 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev))
    cfg = euler.EulerConfig(dt=2e-3, steps=per_frame, buoyancy=0.5, advection="maccormack", projection="fft")
    with torch.no_grad(), plain_transport():
        for _ in range(frames):
            state, _ = euler.rollout(g, state, cfg)
    d_sig = rel(torch.tensor(sig_k, device=dev), state.sigma)
    d_u = rel(torch.tensor(u_k, device=dev), state.u)
    print(f"phase 4 cli simulate {g.nx}x{g.ny}x{g.nz} maccormack, {frames} frames x {per_frame} steps: launches "
          f"{got}, final max_abs_div {out['final_max_abs_div']:.3e}; final frame vs the plain rollout rel sigma "
          f"{d_sig:.3e} u {d_u:.3e} (<= 1e-5)")
    check(got == {"transport": 4 * frames * per_frame}, "simulate (maccormack) launches K8 4 times a step")
    check(d_sig <= 1e-5 and d_u <= 1e-5 and np.isfinite(out["final_max_abs_div"]), "simulate vs plain rollout")
    _build.reset_launches()
    out = run_cli(["simulate", "--grid", f"{g.nx}x{g.ny}x{g.nz}", "--frames", "1", "--steps-per-frame",
                   str(per_frame), "--advection", "semi_lagrangian", "--out", os.path.join(tmp, "sim_sl", "roll")])
    got = launched()
    print(f"phase 4 cli simulate semi_lagrangian, 1 frame x {per_frame} steps: launches {got}, final max_abs_div "
          f"{out['final_max_abs_div']:.3e}")
    check(got == {"transport": 2 * per_frame}, "simulate (semi_lagrangian) launches K8 twice a step")

    # simulate --ckpt from the fitted model, clamp, a sphere obstacle (the
    # masked CGNR projection), at a small grid
    gs = GridSpec(nx=32, ny=24, nz=16, hx=gm.hx, hy=gm.hy, hz=gm.hz, dt=gm.dt, periodic=False)
    small_ckpt = os.path.join(tmp, "mlp_small_clamp.npz")
    modelio.save_model(small_ckpt, gs, mcfg, params)
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run_cli(["simulate", "--ckpt", small_ckpt, "--obstacle", "sphere:8,12,16:0.2", "--frames", "1",
                   "--steps-per-frame", "2", "--out", os.path.join(tmp, "sim_ckpt", "roll")])
    got = launched()
    sig_c, u_c = read_vtk(os.path.join(tmp, "sim_ckpt", "roll_0000.vtk"), gs)
    print(f"phase 4 cli simulate --ckpt (the fitted MLP on 32x24x16 clamp, a sphere obstacle, CGNR): launches "
          f"{got}, final max_abs_div {out['final_max_abs_div']:.3e}, {time.perf_counter() - t0:.2f} s")
    check(got == {"transport": 8} and np.isfinite(sig_c).all() and np.isfinite(u_c).all(),
          "simulate --ckpt clamp with an obstacle")
    return counts


# ---------------------------------------------------------------------------
# The NGP path's reduced tiers (K5 bf16 / f32_fastbwd, K7 bf16) and K1's
# bf16-I/O entry points
# ---------------------------------------------------------------------------

#: The outputs of the kernels that share sources with the redesigned ones
#: at kernels/tier_bench's fixed inputs (its f32_k5_outputs and
#: held_outputs), as tier_bench --save printed them: f32 K5's for the tree
#: before K5's reduced tiers were redesigned, K4 bf16's and K7 bf16's for
#: the tree after their redesign, the others for the tree before K4 bf16's
#: adjoint and K7 bf16 were (NVIDIA H100 80GB HBM3, 700.00 W). K3 bf16's
#: redesign keeps its outputs; K6 bf16's is held to its plain version.
HELD_DIGESTS = {
    "K5 f32 case 0": "3e6862e9b4192015", "K5 f32 shard 24": "0a007ef1f07e7a40",
    "K4 bf16 loss": "9cc325af16001c9e", "K4 bf16": "413836a862056d48", "K4 f32": "f33e3af86d12a09b",
    "K2 bf16": "28c271de90684479", "K2 bf16x3": "f8079a163190c0ce", "K3 bf16": "9cc325af16001c9e",
    "K6 f32": "724c462ff30bcf59", "K5 bf16": "56fa505e68318665", "K5 f32_fastbwd": "fb12ca7fc80e597b",
    "K7 f32": "737b5e178eb5f8f4", "K7 bf16": "34b215b4a2c17a83",
}

#: The limits of a bf16-tier kernel against its plain version (the same
#: rounding points, float32 sums in another order), as for the MLP's bf16
#: kernels: losses 1e-4 relative, gradients 1e-3 relative L2 (an
#: intermediate rounded to bf16 (gy, a1, dz1) flips by one ulp where the two
#: float32 values it rounds differ in their last bits).
TIER_LOSS, TIER_GRAD = 1e-4, 1e-3


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def host(x):
    return x.detach().float().cpu().numpy()


def cat(xs):
    return torch.cat([x.reshape(-1).float() for x in xs])


def head_tier_inputs(dev, g, lf, h, seed, t):
    """Random head inputs at any LF and H (the encoding N(0, 1), Glorot
    weights, biases N(0, 0.3)): (enc, W1, b1, W2, b2, ts)."""
    from phys_autodiff_tpu_torch.models.fields import slice_times

    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32), device=dev)

    enc = mk(g.nz, lf, g.ny, g.nx)
    w1 = mk(lf + 1, h, scale=math.sqrt(2.0 / (lf + 1 + h)))
    w2 = mk(h, 4, scale=math.sqrt(2.0 / (h + 4)))
    return enc, w1, mk(h, scale=0.3), w2, mk(4, scale=0.3), slice_times(torch.full((), t, device=dev), g.dt)


def tier_edges(fits):
    """(dims, periodic, scheme, LF, H) at the edges of the head core for a
    gate `fits(lf, h)`: LF and H at 1, 4k -+ 1 and the gate's top."""
    from phys_autodiff_tpu_torch.kernels import _build

    def top(lf):
        return _build.gate_top(lambda h: h <= 256 and fits(lf, h))

    return [
        ((40, 9, 2), True, "central", 1, 1),
        ((24, 13, 5), False, "upwind", 15, 65),
        ((33, 9, 2), True, "upwind", 17, 63),
        ((7, 3, 1), False, "central", 64, top(64)),
        ((40, 9, 1), True, "central", 16, top(16)),
        ((36, 9, 3), False, "upwind", 3, top(3)),
    ]


def ngp_tier_parity(report, check, dev, flagship, t, ngp_conditioned, make_target):
    """Phase 3: K5 bf16, K5 f32_fastbwd and K7 bf16 against their plain
    versions (the same rounding points written out: mega_ngp.
    head_backward_plain) at the flagship and at the head core's edges;
    the fastbwd loss equal to f32 K5's to the bit, and no tier launch the
    f32 kernel (its gradients lie more than 1e-4 from the f32 kernel's).
    Returns the max abs errors of the flagship calls, by kernel."""
    from phys_autodiff_tpu_torch import GridSpec, PhysWeights
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.models import encoders, ngp
    from phys_autodiff_tpu_torch.models.fields import slice_times
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

    w5, wf = PhysWeights(w_sigma=1.3, w_u=0.7), PhysWeights(w_sigma=1.3, w_u=0.6)
    errs = {}
    # The kernels that share sources with the redesigned ones keep their
    # code: their outputs at kernels/tier_bench's fixed inputs against the
    # digests a run of the tree before each redesign recorded on an H100.
    from phys_autodiff_tpu_torch.kernels import tier_bench

    held = {**tier_bench.f32_k5_outputs(dev), **tier_bench.held_outputs(dev)}
    for name, xs in held.items():
        got = tier_bench.digest(xs)
        print(f"phase 3 parity held {name} outputs: digest {got}, recorded {HELD_DIGESTS[name]}: bitwise equal "
              f"{got == HELD_DIGESTS[name]}")
        check(got == HELD_DIGESTS[name], f"{name}: the outputs of the tree before the redesign, to the bit")
    del held
    torch.cuda.empty_cache()

    def k5_tier(g, args, need_denc, tier, tag):
        name = f"mega_ngp {tier}"
        loss, cot = k5.head_loss_and_grad(g, w5, *args, tier, need_denc=need_denc)
        loss_p, cot_p = k5.head_loss_and_grad_plain(g, w5, *args, tier, need_denc=need_denc)
        loss_32, cot_32 = k5.head_loss_and_grad(g, w5, *args, need_denc=need_denc)
        torch.cuda.synchronize()
        report(name, f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), TIER_LOSS, "rel")
        for leaf, x, y in zip(("dEnc", "dW1", "db1", "dW2", "db2"), cot, cot_p):
            if x is not None:
                report(name, f"{tag} {leaf}", rel_l2_err(host(x), host(y)), TIER_GRAD)
        keep = [x for x in cot if x is not None]
        d32 = rel_l2_err(host(cat(keep)), host(cat([x for x in cot_32 if x is not None])))
        same = torch.equal(loss, loss_32)
        print(f"phase 3 parity {name} {tag} gradients vs the f32 kernel: rel_l2 {d32:.3e} (> 1e-04); loss bitwise "
              f"equal to f32 K5's: {same}")
        check(d32 > 1e-4, f"K5 {tier} {tag} is not the f32 kernel")
        if tier == "f32_fastbwd":
            check(same, f"K5 f32_fastbwd {tag}: the loss is f32 K5's to the bit")
        return max_abs_err(host(cat([loss, *keep])), host(cat([loss_p, *(y for y in cot_p if y is not None)])))

    def k7_tier(g, args, need_denc, tag):
        loss, cot = kfit.ngp_fit_head_loss_and_grad(g, wf, *args, "bf16", need_denc=need_denc)
        loss_p, cot_p = kfit.ngp_fit_head_loss_and_grad_plain(g, wf, *args, "bf16", need_denc=need_denc)
        _, cot_32 = kfit.ngp_fit_head_loss_and_grad(g, wf, *args, need_denc=need_denc)
        torch.cuda.synchronize()
        report("fit_ngp bf16", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), TIER_LOSS, "rel")
        for leaf, x, y in zip(("dEnc", "dW1", "db1", "dW2", "db2"), cot, cot_p):
            if x is not None:
                report("fit_ngp bf16", f"{tag} {leaf}", rel_l2_err(host(x), host(y)), TIER_GRAD)
        keep = [x for x in cot if x is not None]
        d32 = rel_l2_err(host(cat(keep)), host(cat([x for x in cot_32 if x is not None])))
        print(f"phase 3 parity fit_ngp bf16 {tag} gradients vs the f32 kernel: rel_l2 {d32:.3e} (> 1e-04)")
        check(d32 > 1e-4, f"K7 bf16 {tag} is not the f32 kernel")
        return max_abs_err(host(cat([loss, *keep])), host(cat([loss_p, *(y for y in cot_p if y is not None)])))

    # the flagship, as the main path calls the kernels: NGPFieldConfig() on
    # 128x96x96, the encoding of the tier (bf16: the fast encode)
    ncfg = ngp.NGPFieldConfig()
    p = ngp_conditioned(ncfg, 777)
    ts = slice_times(torch.full((), t, device=dev), flagship.dt)
    target = kfit.pack_target(flagship, *make_target(flagship))
    head = tuple(p[k].contiguous() for k in ("W1", "b1", "W2", "b2"))
    for tier in ("bf16", "f32_fastbwd"):
        enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], flagship, fast=tier == "bf16").contiguous()
        errs[f"mega_ngp {tier}"] = k5_tier(flagship, (enc, *head, ts), True, tier, "128x96x96 NGPFieldConfig()")
        if tier == "bf16":
            errs["fit_ngp bf16"] = k7_tier(flagship, (enc, *head, ts[1], target), True,
                                           "128x96x96 NGPFieldConfig()")
            k7_tier(flagship, (enc, *head, ts[1], target), False, "128x96x96 NGPFieldConfig() need_denc=False")
        del enc
        torch.cuda.empty_cache()
    # the whole step: ngp_loss_and_grad (fast encode, kernel, pull-back)
    # against the same step with the plain head
    for tier in ("bf16", "f32_fastbwd"):
        lg, (gp, gt) = k5.ngp_loss_and_grad(flagship, w5, ncfg, p, t, tier)
        lg_p, (gp_p, gt_p) = k5._loss_and_grad(flagship, w5, ncfg, p, t, tier, k5.head_loss_and_grad_plain)
        report(f"mega_ngp {tier}", "128x96x96 step loss", rel(lg, lg_p), TIER_LOSS, "rel")
        report(f"mega_ngp {tier}", "128x96x96 step gradient",
               rel_l2_err(host(cat(tree.leaves(gp))), host(cat(tree.leaves(gp_p)))), TIER_GRAD)
    # the head core's edges: LF, H at 1, 4k -+ 1 and each gate's top
    for dims, periodic, scheme, lf, h in tier_edges(lambda lf, h: k5.ngp_fits(lf, h, "bf16")):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        args = head_tier_inputs(dev, g, lf, h, lf * 1000 + h, t)
        tag = f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} LF={lf} H={h}"
        for tier in ("bf16", "f32_fastbwd"):
            k5_tier(g, args, True, tier, tag)
        k5_tier(g, args, False, "bf16", tag + " need_denc=False")
    for dims, periodic, _, lf, h in tier_edges(lambda lf, h: kfit.ngp_fit_fits(lf, h, "bf16")):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
        enc, w1, b1, w2, b2, ts_g = head_tier_inputs(dev, g, lf, h, lf * 1000 + h + 1, t)
        tgt = kfit.pack_target(g, *make_target(g))
        tag = f"{dims[0]}x{dims[1]}x{dims[2]} {'periodic' if periodic else 'clamp'} LF={lf} H={h}"
        k7_tier(g, (enc, w1, b1, w2, b2, ts_g[1], tgt), True, tag)
        k7_tier(g, (enc, w1, b1, w2, b2, ts_g[1], tgt), False, tag + " need_denc=False")
    return errs


def k1_low_parity(report, check, dev, grids):
    """Phase 3: K1's bf16-I/O entry points. Each against the f32 kernel on
    the upcast input, rounded to bf16 (the same float32 arithmetic: bitwise
    equal), and against its plain version (the staged residuals rounded:
    one bf16 ulp, as the float32 residuals differ in their last bits).
    Returns the max abs errors against the plain version at grids[0]."""
    from phys_autodiff_tpu_torch.kernels import residuals as kres

    errs = {"residuals bf16": 0.0, "residuals mixed_out": 0.0}
    for i, g in enumerate(grids):
        rng = np.random.default_rng(i)
        packed = torch.tensor(rng.uniform(-0.5, 0.5, (12,) + g.shape).astype(np.float32), device=dev)
        tag = f"{g.nx}x{g.ny}x{g.nz} {g.scheme} {'periodic' if g.periodic else 'clamp'}"
        for kind, x, fn in (("bf16", packed.to(torch.bfloat16), kres.residuals_fused_packed_bf16),
                            ("mixed_out", packed, kres.residuals_fused_packed_mixed_out)):
            out = fn(g, x)
            via_f32 = kres.residuals_fused_packed(g, x.float()).to(torch.bfloat16)
            plain = kres.residuals_low_out_plain(g, x)
            torch.cuda.synchronize()
            same = torch.equal(out, via_f32)
            ulps = int((out.view(torch.int16).int() - plain.view(torch.int16).int()).abs().max())
            print(f"phase 3 parity residuals {kind} {tag}: bitwise equal to the f32 kernel rounded {same}; vs the "
                  f"plain version {ulps} bf16 ulp (<= 1)")
            check(out.dtype == torch.bfloat16 and same and ulps <= 1, f"K1 {kind} {tag}")
            if i == 0:
                errs[f"residuals {kind}"] = float((out.float() - plain.float()).abs().max())
    return errs


def ngp_tier_slice(check, dev, g, t, steps, make_target, run_cli, tmp):
    """Phase 4: the NGP path's reduced tiers through the entry points at
    NGPFieldConfig() on 128x96x96. `steps` steps of make_ngp_train_step(
    precision=tier, backward="mega") for bf16 and f32_fastbwd (K5's tier
    once a step, the f32 kernel never), run twice (bitwise), each step held
    at the params it started from to the same step with the plain head
    (TIER_LOSS, TIER_GRAD); `steps` NGP fit_field steps in bf16 (K7 bf16
    once a step) and a composite with phys_weight 0.1 (K7 and K5 bf16 once a
    step each), each run twice; then `train` through the CLI where K5 cannot
    take the head (Fourier with 11 octaves, LF = 69; H = 256): "auto" takes
    xla (no K5 launch) and finishes. Returns the tier kernels' launches of
    one run."""
    from phys_autodiff_tpu_torch import PhysWeights
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.models import ngp
    from phys_autodiff_tpu_torch.train import TrainConfig, make_ngp_train_step
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

    w = PhysWeights()
    ncfg = ngp.NGPFieldConfig()
    p0 = ngp.init_ngp_params(ncfg, seed=777, device=dev)
    launches = {}

    def run(make, n):
        step, state = make()
        snaps, losses = [], []
        for _ in range(n):
            snaps.append(tree.map_tree(lambda x: x.detach().clone(), state.params))
            state, loss = step(state)
            losses.append(loss)
        torch.cuda.synchronize()
        return state, losses, snaps

    def rerun_same(make, n, state, losses, what):
        state_2, losses_2, _ = run(make, n)
        same_loss = all(torch.equal(a, b) for a, b in zip(losses, losses_2))
        same_params = all(torch.equal(a, b) for a, b in zip(tree.leaves(state.params), tree.leaves(state_2.params)))
        print(f"phase 4 {what}: rerun from the same seed: losses bitwise equal {same_loss}, params bitwise equal "
              f"{same_params}")
        check(same_loss and same_params, f"two runs of the {what} give the same bits")

    tcfg = TrainConfig(learning_rate=1e-3, seed=777, t=t)
    for tier in ("bf16", "f32_fastbwd"):
        def make(tier=tier):
            return make_ngp_train_step(g, w, ncfg, tcfg, p0, tier, backward="mega")

        _build.reset_launches()
        state, losses, snaps = run(make, steps)
        got = dict(_build.LAUNCHES)
        name = f"mega_ngp {tier}"
        launches[name] = got[name]
        print(f"phase 4 ngp {tier}: {steps} steps of make_ngp_train_step(backward='mega'), launches {name} "
              f"{got[name]}, mega_ngp {got['mega_ngp']}; losses {', '.join(f'{float(x):.7g}' for x in losses)}")
        check(got[name] == steps and got["mega_ngp"] == 0, f"K5 {tier} once a step, the f32 kernel never")
        check(all(bool(torch.isfinite(x).all()) for x in tree.leaves(state.params)), f"NGP {tier} params finite")
        rerun_same(make, steps, state, losses, f"ngp {tier} steps")
        for i, (snap, lm) in enumerate(zip(snaps, losses), start=1):
            _, (gk, _) = k5.ngp_loss_and_grad(g, w, ncfg, snap, t, tier)
            lp, (gp, _) = k5._loss_and_grad(g, w, ncfg, snap, t, tier, k5.head_loss_and_grad_plain)
            d_loss, d_grad = rel(lm, lp), rel_l2_err(host(cat(tree.leaves(gk))), host(cat(tree.leaves(gp))))
            print(f"phase 4 ngp {tier} step {i}: loss K5 {float(lm):.9g} plain {float(lp):.9g} rel {d_loss:.3e} "
                  f"(<= {TIER_LOSS:.0e}); gradient rel {d_grad:.3e} (<= {TIER_GRAD:.0e})")
            check(d_loss <= TIER_LOSS and d_grad <= TIER_GRAD, f"NGP {tier} step {i} against its plain version")
        del state, snaps
        torch.cuda.empty_cache()

    sigma_t, u_t = make_target(g)
    tgt = ff.FitTarget(sigma_t, u_t, t)
    packed = kfit.pack_target(g, sigma_t, u_t)
    fcfg = TrainConfig(learning_rate=5e-3, precision="bf16")
    for phys_weight in (0.0, 0.1):
        def make(phys_weight=phys_weight):
            return ff.make_fit_step(g, ncfg, [tgt], fcfg, params0=p0, engine="mega", phys_weight=phys_weight)

        _build.reset_launches()
        state, losses, snaps = run(make, steps)
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        what = f"fit ngp bf16{' composite' if phys_weight else ''}"
        print(f"phase 4 {what}: {steps} steps of make_fit_step(engine='mega'), launches {got}; losses "
              f"{', '.join(f'{float(x):.7g}' for x in losses)}")
        encodes = steps * (2 if phys_weight else 1)  # the fast encode and its pull-back, a call of each kernel
        want = {"fit_ngp bf16": steps, **({"mega_ngp bf16": steps} if phys_weight else {}),
                "hash_encode bf16": encodes, "hash_encode bf16 pullback": encodes}
        check(got == want, f"{what}: K7 bf16 (and K5 bf16) and the fast encode's pair once a step, nothing else")
        if not phys_weight:
            launches["fit_ngp bf16"] = got.get("fit_ngp bf16", 0)
        rerun_same(make, steps, state, losses, what)
        if not phys_weight:
            for i, (snap, lm) in enumerate(zip(snaps, losses), start=1):
                lp, (gp, _) = kfit._ngp_loss_and_grad(g, ncfg, snap, packed, t, PhysWeights(), "bf16",
                                                      kfit.ngp_fit_head_loss_and_grad_plain)
                _, (gk, _) = kfit.ngp_fit_loss_and_grad(g, ncfg, snap, packed, t, PhysWeights(), "bf16")
                d_loss, d_grad = rel(lm, lp), rel_l2_err(host(cat(tree.leaves(gk))), host(cat(tree.leaves(gp))))
                print(f"phase 4 {what} step {i}: loss K7 {float(lm):.9g} plain {float(lp):.9g} rel {d_loss:.3e} "
                      f"(<= {TIER_LOSS:.0e}); gradient rel {d_grad:.3e} (<= {TIER_GRAD:.0e})")
                check(d_loss <= TIER_LOSS and d_grad <= TIER_GRAD, f"{what} step {i} against its plain version")
        del state, snaps
    del sigma_t, u_t, tgt, packed
    torch.cuda.empty_cache()

    # K1's bf16-I/O entry points on the NGP's packed fields, forward and
    # backward (the staged float32 adjoint: no launch)
    from phys_autodiff_tpu_torch.kernels import residuals as kres

    fields = ngp.generate_fields_packed(g, ncfg, p0, t, g.dt).detach()
    for kind, fn, x in (("bf16", kres.residuals_fused_packed_bf16, fields.to(torch.bfloat16)),
                        ("mixed_out", kres.residuals_fused_packed_mixed_out, fields)):
        x = x.requires_grad_()
        _build.reset_launches()
        out = fn(g, x)
        (dx,) = torch.autograd.grad(out.float().square().sum(), x)
        torch.cuda.synchronize()
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        launches[f"residuals {kind}"] = got.get(f"residuals {kind}", 0)
        same = torch.equal(out, kres.residuals_fused_packed(g, x.detach().float()).to(torch.bfloat16))
        print(f"phase 4 residuals_fused_packed_{kind} on the NGP's packed fields: launches {got}; equal to the f32 "
              f"kernel rounded {same}; gradient {dx.dtype} finite {bool(torch.isfinite(dx.float()).all())}")
        check(got == {f"residuals {kind}": 1} and same and dx.dtype == x.dtype and bool(torch.isfinite(dx.float()).all()),
              f"K1 {kind} through its entry point")
    del fields, x, out, dx

    for extra, what in ((["--family", "fourier", "--frequencies", "11"], "Fourier LF=69"),
                        (["--family", "ngp", "--hidden", "256"], "H=256")):
        _build.reset_launches()
        out = run_cli(["train", "--grid", f"{g.nx}x{g.ny}x{g.nz}", *extra, "--steps", "2",
                       "--out", os.path.join(tmp, "f10.npz")])
        got = {k: v for k, v in _build.LAUNCHES.items() if v}
        print(f"phase 4 cli train {what} (backward auto, outside K5's gate): launches {got}; {out}")
        check(got.get("mega_ngp", 0) == 0 and got.get("residuals", 0) == 2,
              f"train {what}: auto takes xla (K1's fused loss, no K5)")
    return launches


# ---------------------------------------------------------------------------
# The z-sharded path: the shard-local builds of K4-K7 and the sharded steps
# ---------------------------------------------------------------------------

#: The shard-local kernels' rows in the JSON line, by tier (K4 f32 and bf16;
#: K5 f32, bf16 and f32_fastbwd; K6 and K7 f32 and bf16).
SHARD_ROWS = ("mega_bwd shard", "mega_bwd bf16 shard", "mega_ngp shard", "mega_ngp bf16 shard",
              "mega_ngp f32_fastbwd shard", "fit shard", "fit bf16 shard", "fit_ngp shard", "fit_ngp bf16 shard")
SPLITS = (2, 4)


def world_of_one(dev):
    """A world-size-1 NCCL group on this card (an in-process HashStore: no
    network) and its z mesh."""
    import torch.distributed as dist

    from phys_autodiff_tpu_torch.parallel.mesh import make_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    return make_mesh(device=dev)


def _shard_counter(kernel, tier):
    return f"{kernel} shard" if tier == "f32" else f"{kernel} {tier} shard"


def shard_parity(report, check, dev, flagship, t, ngp_conditioned, make_target):
    """Phase 3: each shard-local build against its plain version on every
    shard of the 2- and 4-way splits of 128x96x96 (both boundaries; K4 and
    K5 also on a ragged upwind clamp grid), and the shards' sum against the
    whole-grid kernel: the loss chained from the shards' plane partials and
    the owned-row outputs (dCD, dEnc) equal to the bit where the card
    computes each row's value alike (printed; held to 1e-7 and 1e-6), the
    summed table and head gradients within 1e-4. Each shard's kernel is
    held to a float64 referee where a shard's partial sums cancel (K4 both
    tiers: kernels/mega_bwd.table_loss_and_grad_shard_ref, at k4_parity's
    limits: partials 5e-6, or 1e-4 in bf16, each leaf 1e-3, the
    concatenation 1e-4, or 1e-3 in bf16; K5 f32: head_loss_and_grad_shard_ref
    at K5's referee limits: partials 1e-5, leaves 1e-4 periodic / 5e-3
    clamped), and to its plain version elsewhere: K5's bf16 and fastbwd
    tiers and K6 / K7 bf16 at the tiers' (1e-4, 1e-3), K6 and K7 f32 at
    their witness's (1e-6, 1e-4). Returns each row's largest absolute
    error of the gradients (the raw plane partials, unscaled sums of
    squares, are held by their relative error above)."""
    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega_bwd as kbwd
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.kernels.residuals import sum_plane_partials
    from phys_autodiff_tpu_torch.models import encoders, mlp, ngp
    from phys_autodiff_tpu_torch.models.fields import slice_times
    from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err

    errs = {name: 0.0 for name in SHARD_ROWS}
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    grids = [("128x96x96 periodic", flagship), ("128x96x96 clamp", dataclasses.replace(flagship, periodic=False)),
             ("40x9x8 upwind clamp", GridSpec(40, 9, 8, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=False,
                                              scheme="upwind"))]

    def compare(row, tag, got, want, names, lim_parts, lim_leaf, lim_cat, leaf_lims=None):
        report(row, f"{tag} partials", rel_l2_err(host(got[0]), host(want[0])), lim_parts)
        for i, (name, x, y) in enumerate(zip(names, got[1], want[1])):
            if x is not None:
                report(row, f"{tag} {name}", rel_l2_err(host(x), host(y)), (leaf_lims or {}).get(name, lim_leaf))
        xs = [x for x in got[1] if x is not None]
        ys = [y for y in want[1] if y is not None]
        report(row, f"{tag} all", rel_l2_err(host(cat(xs)), host(cat(ys))), lim_cat)
        errs[row] = max(errs[row], max_abs_err(host(cat(xs)), host(cat(ys))))

    def sums(row, tag, g, w_, shards, full_loss, full, rows_at, names):
        """The shards' sum against the whole-grid kernel: rows_at gives the
        outputs that are rows (concatenated), the rest are summed."""
        loss = sum_plane_partials(g, w_, torch.cat([p for p, _ in shards], 1))
        same_loss = torch.equal(loss, full_loss)
        report(row, f"{tag} sum: loss", max(rel(loss[k], full_loss[k]) for k in range(2)), 1e-7, "rel")
        for i, name in enumerate(names):
            if full[i] is None:
                continue
            if i in rows_at:
                got = torch.cat([gr[i] for _, gr in shards], 0)
                print(f"phase 3 parity {row} {tag} sum: {name} rows bitwise equal to the whole grid's "
                      f"{torch.equal(got, full[i])}, loss bitwise equal {same_loss}")
                report(row, f"{tag} sum: {name} rows", rel_l2_err(host(got), host(full[i])), 1e-6)
            else:
                got = sum(gr[i] for _, gr in shards)
                report(row, f"{tag} sum: {name}", rel_l2_err(host(got), host(full[i])), 1e-4)

    # K4: the MLP's tables at H = 128
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    kp = mlp.init_params(cfg.dims, seed=777, device=dev)
    k4_names = ("dAB", "dCD", "dW2T", "db2")
    for gtag, g in grids:
        tabs = kmlp.fold_tables(g, cfg, kp, slice_times(t, g.dt))
        for tier in ("f32", "bf16"):
            row = _shard_counter("mega_bwd", tier)
            full_loss, full = kbwd.table_loss_and_grad(g, w, *tabs, tier)
            lims = (5e-6, 1e-3, 1e-4) if tier == "f32" else (1e-4, 1e-3, 1e-3)
            for n in SPLITS:
                nzl, shards = g.nz // n, []
                for r in range(n):
                    got = kbwd.table_loss_and_grad_shard(g, w, *tabs, r * nzl, nzl, tier)
                    want = kbwd.table_loss_and_grad_shard_ref(g, w, *tabs, r * nzl, nzl, tier)
                    compare(row, f"{gtag} {n}-way shard {r}", got, want, k4_names, *lims)
                    shards.append(got)
                sums(row, f"{gtag} {n}-way", g, w, shards, full_loss, full, {1}, k4_names)
        torch.cuda.empty_cache()

    # K5: NGPFieldConfig(), its encoding pre-extended by the shard-local encoder
    ncfg = ngp.NGPFieldConfig()
    p = ngp_conditioned(ncfg, 777)
    head = tuple(p[k].contiguous() for k in ("W1", "b1", "W2", "b2"))
    k5_names = ("dEnc", "dW1", "db1", "dW2", "db2")
    for gtag, g in grids:
        ts = slice_times(torch.full((), t, device=dev), g.dt)
        for tier in ("f32", "bf16", "f32_fastbwd"):
            row = _shard_counter("mega_ngp", tier)
            enc_full = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g, fast=tier == "bf16").contiguous()
            full_loss, full = k5.head_loss_and_grad(g, w, enc_full, *head, ts, tier)
            rows = kbwd.halo_rows(g, g.nz // 4, g.nz // 4, dev)
            sub = encoders.encode_grid_zcf_rows(ncfg.encoding, p["tables"], g, rows, fast=tier == "bf16")
            print(f"phase 3 parity {row} {gtag}: the shard-local encoder's rows (4-way shard 1) bitwise equal to "
                  f"the whole encode's {torch.equal(sub, enc_full[rows])}, rel_l2 "
                  f"{rel_l2_err(host(sub), host(enc_full[rows])):.2e}")
            lim = 1e-4 if g.periodic else 5e-3
            lims = (1e-5, lim, lim) if tier == "f32" else (1e-4, 1e-3, 1e-3)
            leaf_lims = None
            for n in SPLITS:
                nzl, shards = g.nz // n, []
                for r in range(n):
                    # the whole grid's encoding at the shard's rows, so that
                    # both kernels read the same values (the shard-local
                    # encoder's rows are held to the whole encode's on the
                    # CPU and in the sharded steps below)
                    enc = enc_full[kbwd.halo_rows(g, r * nzl, nzl, dev)].contiguous()
                    got = k5.head_loss_and_grad_shard(g, w, enc, *head, ts, r * nzl, nzl, tier)
                    ref = k5.head_loss_and_grad_shard_ref if tier == "f32" else k5.head_loss_and_grad_shard_plain
                    want = ref(g, w, enc, *head, ts, r * nzl, nzl, tier)
                    compare(row, f"{gtag} {n}-way shard {r}", got, want, k5_names, *lims, leaf_lims)
                    shards.append(got)
                sums(row, f"{gtag} {n}-way", g, w, shards, full_loss, full, {0}, k5_names)
            del enc_full
            torch.cuda.empty_cache()

    # K6 and K7 on each shard's rows, at the fit flagship (the trig-mix target)
    g = flagship
    sigma, u = make_target(g)
    target = kfit.pack_target(g, sigma, u)
    w_fit = PhysWeights(w_sigma=1.3, w_u=0.6)
    tabs1 = kmlp.fold_tables(g, cfg, kp, torch.full((1,), t, device=dev))
    tt = torch.full((), t, device=dev)
    enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g).contiguous()
    for tier in ("f32", "bf16"):
        lims = (1e-6, 1e-4, 1e-4) if tier == "f32" else (1e-4, 1e-3, 1e-3)
        row6, row7 = _shard_counter("fit", tier), _shard_counter("fit_ngp", tier)
        full6_loss, full6 = kfit.fit_table_loss_and_grad(g, w_fit, *tabs1, target, tier)
        enc_t = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g, fast=True).contiguous() if tier == "bf16" else enc
        full7_loss, full7 = kfit.ngp_fit_head_loss_and_grad(g, w_fit, enc_t, *head, tt, target, tier)
        for n in SPLITS:
            nzl, shards6, shards7 = g.nz // n, [], []
            for r in range(n):
                z0 = r * nzl
                tg = target[z0:z0 + nzl].contiguous()
                got = kfit.fit_table_loss_and_grad_shard(g, w_fit, *tabs1, tg, z0, nzl, tier)
                want = kfit.fit_table_loss_and_grad_shard_plain(g, w_fit, *tabs1, tg, z0, nzl, tier)
                compare(row6, f"128x96x96 {n}-way shard {r}", got, want, k4_names, *lims)
                shards6.append(got)
                e = enc_t[z0:z0 + nzl].contiguous()
                got = kfit.ngp_fit_head_loss_and_grad_shard(g, w_fit, e, *head, tt, tg, z0, nzl, tier)
                want = kfit.ngp_fit_head_loss_and_grad_shard_plain(g, w_fit, e, *head, tt, tg, z0, nzl, tier)
                compare(row7, f"128x96x96 {n}-way shard {r}", got, want, k5_names, *lims)
                shards7.append(got)
            sums(row6, f"128x96x96 {n}-way", g, w_fit, shards6, full6_loss, full6, {1}, k4_names)
            sums(row7, f"128x96x96 {n}-way", g, w_fit, shards7, full7_loss, full7, {0}, k5_names)
        torch.cuda.empty_cache()
    return errs


def sharded_steps(check, dev, g, t, ngp_conditioned, make_target):
    """Phase 3: the sharded steps over a world-size-1 NCCL group against the
    single-device steps, one step each from one seed: the fused step's mega
    arm (K4's sharded entry point) against make_train_step(use_fused=True)
    (K4), its slab arm against the single-device slab-gradient step, the
    sharded NGP gradient against ngp_loss_and_grad (the NGP params
    conditioned as for K5's parity), the sharded fit step's
    mega engine (K6 and K4, the composite) against make_fit_step's, and the
    sharded fused loss forward (K1 on the halo-extended slab) against K1's.
    The loss within 5e-6 (1e-7 for the fused loss forward) and every
    parameter within 1e-6 relative L2 after the step (tests/test_sharding.py
    :227-229), whether each is bitwise equal printed."""
    from phys_autodiff_tpu_torch import MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels.residuals import loss_forward_fused
    from phys_autodiff_tpu_torch.models import fields as fields_mod
    from phys_autodiff_tpu_torch.models import mlp, ngp
    from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
    from phys_autodiff_tpu_torch.parallel import sharded as sh
    from phys_autodiff_tpu_torch.parallel.mesh import shard_fields
    from phys_autodiff_tpu_torch.train import TrainConfig, make_train_step, state_from_params
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.train.loop import _apply_grads, make_schedule
    from phys_autodiff_tpu_torch.train.slab_grad import make_fused_loss
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

    mesh = world_of_one(dev)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    p0 = mlp.init_params(cfg.dims, seed=777, device=dev)

    def held(what, loss_n, params_n, loss_1, params_1, loss_lim=5e-6):
        worst = max(rel_l2_err(host(a), host(b)) for a, b in zip(tree.leaves(params_n), tree.leaves(params_1)))
        bitwise = torch.equal(loss_n.float(), loss_1.float()) and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(params_n), tree.leaves(params_1)))
        print(f"phase 3 sharded {what}: loss {float(loss_n):.9g} vs {float(loss_1):.9g} (rel "
              f"{rel(loss_n, loss_1):.2e}), worst param rel_l2 {worst:.2e}; bitwise equal {bitwise}")
        check(rel(loss_n, loss_1) <= loss_lim and worst <= 1e-6, f"the sharded {what} is the single-device one")

    tcfg = TrainConfig(learning_rate=1e-3, seed=777, t=t, use_fused=True)
    step, init = sh.make_sharded_fused_train_step(g, w, cfg, mesh, 1e-3, backward="mega")
    sn, ln = step(init(p0), t)
    s1, l1 = make_train_step(g, w, cfg, tcfg)(state_from_params(tcfg, p0))
    held("fused step, mega arm (1 rank)", ln, sn.params, l1, s1.params)

    step, init = sh.make_sharded_fused_train_step(g, w, cfg, mesh, 1e-3, backward="slab")
    sn, ln = step(init(p0), t)
    loss_fn = make_fused_loss(g, w, cfg, backward="slab")
    state = state_from_params(tcfg, p0)
    l1 = loss_fn(state.params, t)
    grads = dict(zip(state.params, torch.autograd.grad(l1, list(state.params.values()))))
    s1 = _apply_grads(tcfg, make_schedule(tcfg), state, grads)
    held("fused step, slab arm (1 rank)", ln, sn.params, l1.detach(), s1.params)

    ncfg = ngp.NGPFieldConfig()
    pn = ngp_conditioned(ncfg, 777)
    for tier in ("f32", "bf16", "f32_fastbwd"):
        ln, (gn, dtn) = k5.ngp_loss_and_grad_sharded(g, w, ncfg, mesh, tier)(pn, t)
        l1, (g1, dt1) = k5.ngp_loss_and_grad(g, w, ncfg, pn, t, tier)
        worst = max(rel_l2_err(host(a), host(b)) for a, b in zip(tree.leaves(gn), tree.leaves(g1)))
        dt_err = abs(float(dtn) - float(dt1))
        print(f"phase 3 sharded NGP gradient {tier} (1 rank): loss rel {rel(ln, l1):.2e}, worst leaf rel_l2 "
              f"{worst:.2e}, d_t {float(dtn):.7g} vs {float(dt1):.7g}; loss bitwise equal {torch.equal(ln, l1)}")
        check(rel(ln, l1) <= 5e-6 and worst <= 1e-5 and dt_err <= max(1e-5 * abs(float(dt1)), 1e-7),
              f"the sharded NGP gradient ({tier}) is the single-device one (tests/test_mega_ngp.py:192)")

    sigma, u = make_target(g)
    tgt = ff.FitTarget(sigma, u, t)
    fcfg = TrainConfig(learning_rate=3e-3, seed=0)
    step, init = ff.make_sharded_fit_step(g, cfg, [tgt], mesh, fcfg, phys_weight=0.1, engine="mega")
    sn, ln = step(init(p0))
    step1, s1 = ff.make_fit_step(g, cfg, [tgt], fcfg, p0, phys_weight=0.1, engine="mega", device=dev)
    s1, l1 = step1(s1)
    held("fit step, mega engine (1 rank)", ln, sn.params, l1, s1.params)

    fs = FieldSnapshots(*(x.contiguous() for x in fields_mod.generate_fields(g, cfg, p0, t, g.dt)))
    ls_n, lu_n = sh.loss_forward_fused_sharded(g, w, mesh, shard_fields(mesh, fs))
    ls_1, lu_1 = loss_forward_fused(g, w, fs)
    same = torch.equal(ls_n, ls_1) and torch.equal(lu_n, lu_1)
    print(f"phase 3 sharded fused loss forward (1 rank): rel {max(rel(ls_n, ls_1), rel(lu_n, lu_1)):.2e}; "
          f"bitwise equal {same}")
    check(max(rel(ls_n, ls_1), rel(lu_n, lu_1)) <= 1e-7, "the sharded fused loss is the single-device one")
    torch.cuda.empty_cache()


def f12_parity(check, dev, g, t):
    """Phase 3, F12: the fused training step past K4's gate (H = 1400: K3
    forward, the slab-recompute backward) against the plain step (autograd
    of the staged loss), on 128x96x32 (the plain step's activations at
    H = 1400 fit the card there): the loss 5e-6 and the gradient 1e-4 on
    the concatenation, 1e-3 a leaf (tests/test_slab_grad.py's classes)."""
    from phys_autodiff_tpu_torch import MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import mega_bwd as kbwd
    from phys_autodiff_tpu_torch.models import mlp
    from phys_autodiff_tpu_torch.train import loss_fn
    from phys_autodiff_tpu_torch.utils.metrics import rel_l2_err

    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=1400))
    check(not kbwd.mega_fits(g, 1400), "H = 1400 lies past K4's gate")
    p = {k: v.requires_grad_() for k, v in mlp.init_params(cfg.dims, seed=777, device=dev).items()}
    keys = sorted(p)
    _build.reset_launches()
    lf = loss_fn(g, w, cfg, p, t, use_fused=True)
    gf = torch.autograd.grad(lf, [p[k] for k in keys])
    lf = lf.detach()
    torch.cuda.synchronize()
    launched = {k: v for k, v in _build.LAUNCHES.items() if v}
    lp = loss_fn(g, w, cfg, p, t)
    gp = torch.autograd.grad(lp, [p[k] for k in keys])
    lp = lp.detach()
    worst = max(rel_l2_err(host(a), host(b)) for a, b in zip(gf, gp))
    err = rel_l2_err(host(cat(gf)), host(cat(gp)))
    print(f"phase 3 parity F12 fused step H=1400 {g.nx}x{g.ny}x{g.nz}: launches {launched}; loss rel "
          f"{rel(lf, lp):.2e}, gradient rel_l2 {err:.2e}, worst leaf {worst:.2e}")
    check(launched == {"mega": 1} and rel(lf, lp) <= 5e-6 and err <= 1e-4 and worst <= 1e-3,
          "the fused step past K4's gate: K3 once, the slab gradient, the plain step's loss and gradient")
    del gf, gp, p
    torch.cuda.empty_cache()


def shard_slice(check, dev, g, t, make_target):
    """Phase 4: the sharded entry points over the world-size-1 NCCL group,
    with their launch counts: the fused step's mega arm in f32 and bf16 (2
    steps each: the shard-local K4 of the tier once a step), its slab arm
    (1 step: no kernel), the sharded NGP gradient in each K5 tier (once),
    the sharded fit step's mega engine with the composite (phys_weight 0.1)
    for the MLP and the NGP in f32 and bf16 (1 step: the tier's K6 or K7 and
    K4 or K5 once each), and the sharded fused loss forward (K1 once).
    Returns the shard-local kernels' launches of this run."""
    from phys_autodiff_tpu_torch import MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.models import fields as fields_mod
    from phys_autodiff_tpu_torch.models import mlp, ngp
    from phys_autodiff_tpu_torch.parallel import sharded as sh
    from phys_autodiff_tpu_torch.parallel.mesh import shard_fields
    from phys_autodiff_tpu_torch.train import TrainConfig
    from phys_autodiff_tpu_torch.train import fit_field as ff

    mesh = world_of_one(dev)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    ncfg = ngp.NGPFieldConfig()
    p0 = mlp.init_params(cfg.dims, seed=777, device=dev)
    pn = ngp.init_ngp_params(ncfg, seed=777, device=dev)
    sigma, u = make_target(g)
    tgt = ff.FitTarget(sigma, u, t)
    expect = {name: 0 for name in SHARD_ROWS}
    _build.reset_launches()
    for tier in ("f32", "bf16"):
        step, init = sh.make_sharded_fused_train_step(g, w, cfg, mesh, 1e-3, precision=tier, backward="mega")
        state = init(p0)
        for _ in range(2):
            state, loss = step(state, t)
        check(bool(torch.isfinite(loss)), f"the sharded fused step ({tier}) gives a finite loss")
        expect[_shard_counter("mega_bwd", tier)] += 2
    step, init = sh.make_sharded_fused_train_step(g, w, cfg, mesh, 1e-3, backward="slab")
    _, loss = step(init(p0), t)
    check(bool(torch.isfinite(loss)), "the sharded fused step's slab arm gives a finite loss")
    for tier in ("f32", "bf16", "f32_fastbwd"):
        loss, _ = k5.ngp_loss_and_grad_sharded(g, w, ncfg, mesh, tier)(pn, t)
        check(bool(torch.isfinite(loss)), f"the sharded NGP gradient ({tier}) gives a finite loss")
        expect[_shard_counter("mega_ngp", tier)] += 1
    for model_cfg, fit_row, phys_row in ((cfg, "fit", "mega_bwd"), (ncfg, "fit_ngp", "mega_ngp")):
        for tier in ("f32", "bf16"):
            step, init = ff.make_sharded_fit_step(g, model_cfg, [tgt], mesh,
                                                  TrainConfig(learning_rate=3e-3, seed=0, precision=tier),
                                                  phys_weight=0.1, engine="mega")
            _, loss = step(init())
            check(bool(torch.isfinite(loss)), f"the sharded fit step ({fit_row}, {tier}) gives a finite loss")
            expect[_shard_counter(fit_row, tier)] += 1
            expect[_shard_counter(phys_row, tier)] += 1
    before = _build.LAUNCHES["residuals"]
    fs = fields_mod.generate_fields(g, cfg, p0, t, g.dt)
    ls, lu = sh.loss_forward_fused_sharded(g, w, mesh, shard_fields(mesh, fs))
    torch.cuda.synchronize()
    got = dict(_build.LAUNCHES)
    print(f"phase 4 sharded (1 rank): launches {', '.join(f'{k} {got[k]}' for k in SHARD_ROWS)}, residuals "
          f"{got['residuals'] - before} in the fused loss forward ({float(ls):.7g}, {float(lu):.7g})")
    check(all(got[k] == expect[k] for k in SHARD_ROWS), f"the shard-local kernels launched {expect}")
    check(got["residuals"] - before == 1, "the sharded fused loss forward launches K1 once")
    return {k: got[k] for k in SHARD_ROWS}


def checks_parity(check, dev, g, w, cfg, params, t):
    """Phase 3 "checks": utils/checks.checked around the f32 mega forward
    loss (K3) and the staged K2 -> K1 loss on the flagship: None on the
    seeded params; with a NaN planted in one W2 entry, an error naming the
    kernel that first wrote a NaN (each wrapper reports its launch as one
    primitive through kernels/_build.check). The same for a 5-channel K8
    step with a NaN in its last channel."""
    from phys_autodiff_tpu_torch.kernels import mega as kmega
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.kernels import transport as ktr
    from phys_autodiff_tpu_torch.utils.checks import CheckError, checked

    bad = {k: v.detach().clone() for k, v in params.items()}
    bad["W2"][5, 2] = float("nan")
    for name, kernel, fn in (("mega (K3)", "K3", lambda p: kmega.mega_loss_pipeline(g, w, cfg, p, t)),
                             ("staged (K2 -> K1)", "K2", lambda p: kmlp.fused_loss_pipeline(g, w, cfg, p, t))):
        err, out = checked(fn)(params)
        clean = err.get()
        err_b, out_b = checked(fn)(bad)
        planted = err_b.get()
        try:
            err_b.throw()
            thrown = None
        except CheckError as e:
            thrown = str(e)
        print(f"phase 3 checks {name}: checked() on the flagship params gives {clean!r} (loss "
              f"{float(out[0]):.9g}, {float(out[1]):.9g}); with a NaN in W2[5, 2] it gives {planted!r} (loss "
              f"{float(out_b[0])}, {float(out_b[1])}); throw() raises CheckError {thrown!r}")
        check(clean is None and all(bool(torch.isfinite(x)) for x in out), f"checked {name} on clean params")
        check(planted == f"nan generated by primitive: {kernel}." and thrown == planted,
              f"checked {name} names {kernel} after a NaN in W2")
    # K8 reports its channel launches' output once: a NaN planted in the
    # last channel of C = 5 (the second launch) is named.
    sigma, u = transport_field(g, dev)
    fields = torch.cat([sigma[None], u, 0.5 * sigma[None]])
    bad_f = fields.clone()
    bad_f[4, 7, 11, 13] = float("nan")
    step = lambda f: ktr.transport_step_many_fused(g, f, u, g.dt)  # noqa: E731
    clean, planted = checked(step)(fields)[0].get(), checked(step)(bad_f)[0].get()
    print(f"phase 3 checks transport (K8, C=5, two launches): {clean!r} on the transport-bench field; with a NaN in "
          f"channel 4 it gives {planted!r}")
    check(clean is None and planted == "nan generated by primitive: K8.", "checked K8 on clean and planted fields")


def resilient_slice(check, dev, g, w, cfg, ncfg, t):
    """Phase 4 "resilient K4" and "resilient K5": fit_resilient over the
    flagship MLP training step (use_fused=True: one K4 launch a step) for 12
    steps, save_every=5, with one injected RuntimeError("worker process
    crashed or restarted") at the 7th step call: K4 launches 13 times
    (calls 1-6 and 8-14), and the params, the Adam state, the step and the
    generator are bitwise those of 12 uninterrupted steps from a fresh state
    of the same seed. A second fit_resilient call for 14 steps on the same
    checkpoint continues from 12 (2 launches), bitwise 14 uninterrupted
    steps; assert_all_finite passes on its params and names the leaf where a
    NaN is written. Then make_ngp_train_step(backward="mega") at
    NGPFieldConfig(): 6 steps, save_every=2, a crash at call 4 (K5 launches
    7 times), meta=ngp.checkpoint_meta validated on the resume, bitwise 6
    uninterrupted steps. Also the host wall ms of one checkpoint save of
    each state (median of 5)."""
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.models import ngp
    from phys_autodiff_tpu_torch.train import (TrainConfig, checkpoint, fit_resilient, init_state,
                                               make_ngp_train_step, make_train_step)
    from phys_autodiff_tpu_torch.train.resilient import ResilienceConfig
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.checks import assert_all_finite

    def crashing(make_step, at):
        calls = {"n": 0}

        def factory():
            real = make_step()

            def step(state):
                calls["n"] += 1
                if calls["n"] == at:
                    raise RuntimeError("worker process crashed or restarted")
                return real(state)

            return step

        return factory, calls

    def opt_leaves(state):
        return [torch.as_tensor(v) for _, st in sorted(state.opt.state_dict()["state"].items())
                for _, v in sorted(st.items())]

    def same(a, b):
        """Params, the Adam state, the step and the generator: bitwise."""
        pa, pb, oa, ob = tree.leaves(a.params), tree.leaves(b.params), opt_leaves(a), opt_leaves(b)
        return (a.step == b.step and len(pa) == len(pb) and len(oa) == len(ob) and len(oa) > 0
                and all(torch.equal(x, y) for x, y in zip(pa, pb))
                and all(torch.equal(x, y) for x, y in zip(oa, ob))
                and torch.equal(a.gen.get_state(), b.gen.get_state()))

    def uninterrupted(make_state, make_step, n):
        state, step = make_state(), make_step()
        for _ in range(n):
            state, _ = step(state)
        torch.cuda.synchronize()
        return state

    def run(factory, make_state, steps, rcfg):
        """fit_resilient with the counts set to 0 just before and read just after."""
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fit_resilient(factory, make_state(), steps, rcfg)
        torch.cuda.synchronize()
        return out, {k: v for k, v in _build.LAUNCHES.items() if v}, time.perf_counter() - t0

    def save_ms(rcfg, state):
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            checkpoint.save_npz(rcfg.ckpt_path + "_timed", state, meta=rcfg.meta, extra={"fit_done": 0})
            ms.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ms)), os.path.getsize(rcfg.ckpt_path + "_timed.npz")

    with tempfile.TemporaryDirectory() as tmp:
        # K4: the flagship MLP, one K4 launch a step
        tcfg = TrainConfig(learning_rate=1e-3, seed=777, t=t, use_fused=True)
        make_state = lambda: init_state(tcfg, cfg, device=dev)  # noqa: E731
        make_step = lambda: make_train_step(g, w, cfg, tcfg)  # noqa: E731
        factory, calls = crashing(make_step, 7)
        rcfg = ResilienceConfig(ckpt_path=os.path.join(tmp, "k4"), save_every=5, max_restarts=2)
        (state, hist, rep), launched, sec = run(factory, make_state, 12, rcfg)
        bitwise = same(state, uninterrupted(make_state, make_step, 12))
        print(f"phase 4 resilient K4: 12 steps of make_train_step(use_fused=True) at {g.nx}x{g.ny}x{g.nz} H="
              f"{cfg.dims.H}, save_every 5, a crash at step call 7: {calls['n']} calls, launches {launched}, "
              f"failures {rep.failures}, restores {rep.restores}, checkpoints {rep.checkpoints}, history "
              f"{[(s, round(lo, 9)) for s, lo in hist]}; params, Adam state, step and generator bitwise 12 "
              f"uninterrupted steps {bitwise}; {sec:.2f} s")
        check(launched == {"mega_bwd": 13} and rep.failures == 1 and rep.restores == 1 and state.step == 12
              and [s for s, _ in hist] == [5, 10, 12], "the resilient K4 run: 13 K4 launches, one recovery")
        check(bool(bitwise), "the resilient K4 run is bitwise 12 uninterrupted steps")
        (state, hist, rep), launched, sec = run(make_step, make_state, 14, rcfg)
        bitwise = same(state, uninterrupted(make_state, make_step, 14))
        ms, size = save_ms(rcfg, state)
        print(f"phase 4 resilient K4 resume: fit_resilient(14) on the same checkpoint continues from 12: launches "
              f"{launched}, restores {rep.restores}, history {[s for s, _ in hist]}; bitwise 14 uninterrupted steps "
              f"{bitwise}; checkpoint save {ms:.2f} ms (host wall, median of 5, {size} B)")
        check(launched == {"mega_bwd": 2} and rep.restores == 1 and state.step == 14 and [s for s, _ in hist] == [14]
              and bool(bitwise), "the resumed K4 run: 2 launches, bitwise 14 uninterrupted steps")
        assert_all_finite(state.params, "params")
        bad = {k: v.detach().clone() for k, v in state.params.items()}
        bad["b1"][3] = float("nan")
        try:
            assert_all_finite(bad, "params")
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        print(f"phase 4 checks assert_all_finite: the trained params pass; with a NaN in b1[3] (leaf 2 of "
              f"{sorted(bad)}): {raised!r}")
        check(raised == "non-finite values in params (leaves [2])", "assert_all_finite names the leaf")
        del state, bad

        # K5: NGPFieldConfig(), one K5 launch a step
        ncfg_train = TrainConfig(learning_rate=1e-3, seed=777, t=t)
        p0 = ngp.init_ngp_params(ncfg, seed=777, device=dev)
        make_state = lambda: make_ngp_train_step(g, w, ncfg, ncfg_train, p0, backward="mega")[1]  # noqa: E731
        make_step = lambda: make_ngp_train_step(g, w, ncfg, ncfg_train, p0, backward="mega")[0]  # noqa: E731
        factory, calls = crashing(make_step, 4)
        rcfg = ResilienceConfig(ckpt_path=os.path.join(tmp, "k5"), save_every=2, max_restarts=2,
                                meta=ngp.checkpoint_meta(ncfg))
        (state, hist, rep), launched, sec = run(factory, make_state, 6, rcfg)
        bitwise = same(state, uninterrupted(make_state, make_step, 6))
        meta_ok = checkpoint.read_manifest(rcfg.ckpt_path)["meta"] == ngp.checkpoint_meta(ncfg)
        ms, size = save_ms(rcfg, state)
        print(f"phase 4 resilient K5: 6 steps of make_ngp_train_step(backward='mega') at NGPFieldConfig(), "
              f"save_every 2, a crash at step call 4: {calls['n']} calls, launches {launched}, failures "
              f"{rep.failures}, restores {rep.restores} (meta validated), history "
              f"{[(s, round(lo, 9)) for s, lo in hist]}; bitwise 6 uninterrupted steps {bitwise}; checkpoint "
              f"meta {meta_ok}; checkpoint save {ms:.2f} ms (host wall, median of 5, {size} B); {sec:.2f} s")
        check(launched == {"mega_ngp": 7, "hash_encode": 7, "hash_encode pullback": 7} and rep.failures == 1
              and rep.restores == 1 and state.step == 6
              and [s for s, _ in hist] == [2, 4, 6] and meta_ok, "the resilient K5 run: 7 K5 launches, one recovery")
        check(bool(bitwise), "the resilient K5 run is bitwise 6 uninterrupted steps")


def trace_phase(check, step_fn, loss_fn, smi):
    """Phase 5 "trace": one K4 training step under utils/timing.trace inside
    annotate("train_step"): the exported Chrome trace holds the annotation
    and K4's device kernels (k_bwd_fields, k_bwd_adjoint) inside its time
    range; their device ms. Then what the instrumentation costs: 20 training
    steps' wall ms with and without a trace (the export apart), and the K3
    forward loss under utils/checks.checked beside the unchecked one
    (events, device ms, and the error's one host read)."""
    from phys_autodiff_tpu_torch.utils.checks import checked
    from phys_autodiff_tpu_torch.utils.timing import annotate, call_ms, cuda_time_ms, device_time_ms, trace

    def wall_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    with tempfile.TemporaryDirectory() as tmp:
        step_fn()
        torch.cuda.synchronize()
        with trace(tmp) as tr:
            with annotate("train_step"):
                step_fn()
                torch.cuda.synchronize()
        with open(tr.path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == "train_step"]
        host_span = [e for e in spans if e.get("cat") == "user_annotation"]
        kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
        check(len(host_span) == 1, "the trace holds the train_step annotation")
        t0, t1 = host_span[0]["ts"], host_span[0]["ts"] + host_span[0]["dur"]
        k4 = {k: [e for e in kernels if k in e["name"]] for k in ("k_bwd_fields", "k_bwd_adjoint")}
        inside = all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for es in k4.values() for e in es)
        parts = ", ".join(f"{e['name'][:60]} {e['dur'] / 1e3:.4f} ms" for es in k4.values() for e in es)
        print(f"phase 5 trace: {os.path.basename(tr.path)} ({os.path.getsize(tr.path)} B, {len(events)} events, "
              f"{len(kernels)} kernels, annotation spans {[e.get('cat') for e in spans]}); train_step "
              f"{host_span[0]['dur'] / 1e3:.4f} ms on the host; K4 inside it {inside}: {parts}; {smi}")
        check(all(k4.values()) and inside, "K4's kernels lie inside the train_step annotation")
        plain = wall_ms(step_fn)
        with trace(tmp) as tr2:
            traced = wall_ms(step_fn)
            t_exit = time.perf_counter()
        export = (time.perf_counter() - t_exit) * 1e3
    print(f"phase 5 times trace overhead: train step {plain:.4f} ms (host wall, mean of 20) untraced, {traced:.4f} "
          f"ms traced (CPU and CUDA activity); stopping and exporting the trace {export:.1f} ms")

    err_read = lambda: checked(loss_fn)()[0].get()  # noqa: E731
    for name, fn in (("K3 loss unchecked", loss_fn), ("K3 loss checked", lambda: checked(loss_fn)()),
                     ("K3 loss checked + get()", err_read)):
        ms = cuda_time_ms(fn)
        kt = device_time_ms(fn)
        print(f"phase 5 times checks {name:24s}: {ms:.4f} ms (events), {call_ms(kt):.4f} ms on the device, "
              f"{sum(v.per_call for v in kt.values())} launches a call")
    check(err_read() is None, "the timed checked K3 loss gives no error")


def main() -> None:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # The plain versions run on the card too: keep their float32 matmuls
    # and convolutions out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights, ops
    from phys_autodiff_tpu_torch.entry import entry
    from phys_autodiff_tpu_torch import cli
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega as kmega
    from phys_autodiff_tpu_torch.kernels import mega_bwd as kbwd
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.kernels import residuals as kres
    from phys_autodiff_tpu_torch.kernels import sass_count
    from phys_autodiff_tpu_torch.models import encoders, ngp
    from phys_autodiff_tpu_torch.models import fields as fields_mod
    from phys_autodiff_tpu_torch.models import mlp, modelio, sample
    from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
    from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
    from phys_autodiff_tpu_torch.ref import oracle
    from phys_autodiff_tpu_torch.train import (
        TrainConfig,
        fit,
        loss_fn,
        make_generic_train_step,
        make_ngp_train_step,
        make_train_step,
        state_from_params,
    )
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.train.loop import _apply_grads, make_schedule
    from phys_autodiff_tpu_torch.utils import export
    from phys_autodiff_tpu_torch.utils import tolerances as tol
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.metrics import max_abs_err, rel_l2_err
    from phys_autodiff_tpu_torch.utils.timing import call_ms, cuda_time_ms, device_time_ms, dropped

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    params = mlp.init_params(cfg.dims, seed=777, device=dev)
    t = 0.25

    def spec(nx, ny, nz, **kw):
        return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3, **kw)

    errs = {"residuals": 0.0, "mlp": 0.0, "mega": 0.0, "mega_bwd": 0.0, "mega_ngp": 0.0, "fit": 0.0,
            "fit_ngp": 0.0, "transport": 0.0, "transport_pre": 0.0, "probe": 0.0, "mlp bf16": 0.0,
            "mlp bf16x3": 0.0, "mlp bf16 S=1": 0.0, "mlp bf16x3 S=1": 0.0, "mega bf16": 0.0, "mega_bwd bf16": 0.0,
            "fit bf16": 0.0, "mega_ngp bf16": 0.0,
            "mega_ngp f32_fastbwd": 0.0, "fit_ngp bf16": 0.0, "residuals bf16": 0.0, "residuals mixed_out": 0.0,
            "transport slab": 0.0}

    def report(kernel, what, err, limit, metric="rel_l2"):
        check(np.isfinite(err) and err <= limit, f"{kernel} {what}: {metric} {err} > {limit}")
        print(f"phase 3 parity {kernel:9s} {what}: {metric} {err:.3e} <= {limit:.0e}")

    # ---- 3. kernel vs plain, on the card ---------------------------------
    # First the bf16 tier's packing (csrc/mlp_mma.cuh pack2): one m16n8k16
    # fragment through the kernels' own packing and mma.sync, its registers
    # against torch.bfloat16's bits and D against the float64 product of the
    # rounded operands (16 products, float32 sums: 1e-5 absolute).
    frag_a = torch.tensor(np.random.default_rng(1).normal(size=(16, 16)).astype(np.float32), device=dev)
    frag_b = torch.tensor(np.random.default_rng(2).normal(size=(16, 8)).astype(np.float32), device=dev)
    frag_d = torch.empty(16, 8, device=dev)
    frag_p = torch.empty(16, 8, dtype=torch.int32, device=dev)
    _build.check(_build.lib().pat_mma_check(frag_a.data_ptr(), frag_b.data_ptr(), frag_d.data_ptr(),
                                            frag_p.data_ptr(), _build.stream_ptr(dev)), "mma check")
    torch.cuda.synchronize()
    bits = frag_a.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF
    same_bits = torch.equal(frag_p, bits[:, 0::2] | (bits[:, 1::2] << 16))
    frag_err = float((frag_d.double() - frag_a.to(torch.bfloat16).double() @ frag_b.to(torch.bfloat16).double())
                     .abs().max())
    print(f"phase 3 parity bf16 fragment: pack2 registers equal torch.bfloat16's bits (lower column in the low "
          f"half) {same_bits}; mma.sync D max_abs {frag_err:.3e} <= 1e-05")
    check(same_bits and frag_err <= 1e-5, "the bf16 fragment packing and mma.sync")

    flagship = spec(128, 96, 96)
    for g in (flagship, spec(96, 96, 64), spec(64, 64, 64)):
        tag = f"{g.nx}x{g.ny}x{g.nz}"
        fs = kmlp.generate_fields_fused(g, cfg, params, t)  # the main path's fields
        rs, ru = kres.residuals_fused(g, fs)
        rs_p, ru_p = kres.residuals_plain(g, fs)
        gs, gu = kres.loss_backward_fused(g, w, fs)
        gs_p, gu_p = kres.loss_backward_plain(g, w, fs)
        loss = kres.loss_forward_fused(g, w, fs)
        _, loss_p = kres.loss_partials_plain(g, w, fs)
        torch.cuda.synchronize()
        for what, a, b in (("R", (rs, ru), (rs_p, ru_p)), ("g", (gs, gu), (gs_p, gu_p))):
            for x, y in zip(a, b):
                ma = max_abs_err(host(x), host(y))
                if g is flagship:
                    errs["residuals"] = max(errs["residuals"], ma)
                report("residuals", f"{tag} {what} max", ma, tol.FUSED_VS_STAGED_MAX, "max_abs")
                report("residuals", f"{tag} {what}", rel_l2_err(host(x), host(y)),
                       tol.FUSED_VS_STAGED_REL)
        report("residuals", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), 1e-6, "rel")

    rng = np.random.default_rng(0)
    for periodic in (True, False):
        for scheme in ("central", "upwind"):
            for dims in ((24, 16, 6), (16, 8, 1)):
                g = GridSpec(*dims, hx=0.5, hy=0.6, hz=0.7, dt=0.5, periodic=periodic, scheme=scheme)
                mk = lambda *s: torch.tensor(rng.uniform(-0.5, 0.5, s).astype(np.float32), device=dev)
                fs = FieldSnapshots(mk(*g.shape), mk(*g.shape), mk(*g.shape),
                                    mk(3, *g.shape), mk(3, *g.shape), mk(3, *g.shape))
                tag = f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'}"
                out = torch.cat([x.reshape(-1) for x in kres.residuals_fused(g, fs)])
                ref = torch.cat([x.reshape(-1) for x in kres.residuals_plain(g, fs)])
                report("residuals", f"{tag} R max", max_abs_err(host(out), host(ref)),
                       tol.FUSED_VS_STAGED_MAX, "max_abs")
                loss = kres.loss_forward_fused(g, w, fs)
                _, loss_p = kres.loss_partials_plain(g, w, fs)
                report("residuals", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)),
                       1e-6, "rel")

    g = flagship
    ts = fields_mod.slice_times(t, g.dt)

    def k2_parity(g, kcfg, kp, tag):
        """K2 against its plain version at MLP_INFER_REL: the three slices
        split (sigma, u) and packed (PACKED_ORDER), and the one slice of
        grid_infer. Returns the largest absolute difference."""
        tabs = kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt))
        sig_p, u_p = kmlp.mlp_tables_plain(*tabs)
        fs = kmlp.generate_fields_fused(g, kcfg, kp, t)
        pk = kmlp.generate_fields_fused_packed(g, kcfg, kp, t)
        y1 = kmlp.grid_infer_fused(g, kcfg, kp, t)
        s1, u1 = kmlp.mlp_tables_plain(*kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt)[1:2]))
        y1_p = torch.cat([s1[0][..., None], torch.movedim(u1[0], 0, -1)], dim=-1)
        torch.cuda.synchronize()
        split = torch.cat([torch.stack(fs[:3]).reshape(-1), torch.stack(fs[3:]).reshape(-1)])
        ref = torch.cat([sig_p.reshape(-1), u_p.reshape(-1)])
        pk_p = torch.cat([sig_p, u_p.reshape((-1,) + g.shape)], dim=0)
        for what, x, y in (("3-slice", split, ref), ("packed", pk, pk_p), ("grid_infer", y1, y1_p)):
            report("mlp", f"{tag} {what}", rel_l2_err(host(x), host(y)), tol.MLP_INFER_REL)
        return max(max_abs_err(host(split), host(ref)), max_abs_err(host(y1), host(y1_p)))

    def k3_parity(g, kcfg, kp, tag):
        """K3's loss against its plain version (table MLP -> staged residuals
        -> plane partials -> fixed-order sum) and against K2 -> K1, 1e-5
        relative (the MLP sums in another order than the plain einsum);
        prints whether K3's loss equals K2 -> K1's to the bit."""
        loss = kmega.mega_loss_pipeline(g, w, kcfg, kp, t)
        tabs = kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt))
        loss_p = ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs))
        two = kres.loss_forward_fused(g, w, kmlp.generate_fields_fused(g, kcfg, kp, t))
        torch.cuda.synchronize()
        report("mega", f"{tag} loss vs plain", max(rel(loss[k], loss_p[k]) for k in range(2)), 1e-5, "rel")
        report("mega", f"{tag} loss vs K2->K1", max(rel(loss[k], two[k]) for k in range(2)), 1e-5, "rel")
        same = all(float(loss[k]) == float(two[k]) for k in range(2))
        print(f"phase 3 parity mega      {tag} loss bitwise equal to K2->K1's: {same}")
        return max(abs(float(loss[k]) - float(loss_p[k])) for k in range(2))

    errs["mlp"] = k2_parity(g, cfg, params, "128x96x96 H=128")
    for g in (flagship, spec(128, 64, 64)):  # the flagship and entry()'s grid
        err = k3_parity(g, cfg, params, f"{g.nx}x{g.ny}x{g.nz} H=128")
        if g is flagship:
            errs["mega"] = err

    def mlp_edges(fits):
        """(dims, periodic, scheme, H) at the edges of the tiled MLP core
        (csrc/mlp_head.cuh): hidden-unit pairs and the padding to 4 (H 4,
        33, 100, 200, 512 and the largest H that `fits` takes), tile
        columns and rows (nx 7, 24, 33, 40, ragged ny), chunks and the
        persistent walk (nz 1, 2, 5, 9, 17; 33x9x150 has 600 tile rows for
        264 blocks, so blocks share tiles and ranges cross them; the others
        fewer rows than blocks), both schemes and both boundaries."""
        h_max = max(h for h in range(1, 4097) if fits(h))
        return [((40, 9, 1), True, "central", 4), ((7, 3, 9), False, "upwind", 33),
                ((24, 13, 17), True, "upwind", 100), ((33, 10, 2), False, "central", 200),
                ((40, 9, 5), True, "central", 512), ((33, 9, 150), False, "upwind", 128),
                ((24, 5, 3), True, "upwind", h_max), ((7, 3, 2), False, "central", h_max)]

    def edge_spec(dims, periodic, scheme):
        return GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)

    def edge_tag(dims, periodic, scheme, h):
        return f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} H={h}"

    # K2 and K3 at the edges of the core (their own gates' tops: K2 3632, K3
    # 2124) and on three more small grids at H=128.
    for case in mlp_edges(kmlp.mlp_fits):
        kcfg = MLPGridConfig(dims=MLPDims(H=case[3]))
        k2_parity(edge_spec(*case[:3]), kcfg, mlp.init_params(kcfg.dims, seed=5, device=dev), edge_tag(*case))
    for case in mlp_edges(lambda h: kmega.mega_fwd_fits(flagship, h)):
        kcfg = MLPGridConfig(dims=MLPDims(H=case[3]))
        k3_parity(edge_spec(*case[:3]), kcfg, mlp.init_params(kcfg.dims, seed=5, device=dev), edge_tag(*case))
    for dims, periodic, scheme in (((24, 13, 5), False, "upwind"), ((40, 9, 1), True, "central"),
                                   ((7, 3, 11), True, "upwind")):
        g = GridSpec(*dims, hx=0.3, hy=0.3, hz=0.3, dt=1e-2, periodic=periodic, scheme=scheme)
        k2_parity(g, cfg, params, edge_tag(dims, periodic, scheme, 128))
        k3_parity(g, cfg, params, edge_tag(dims, periodic, scheme, 128))
    torch.cuda.empty_cache()

    # K4 vs its plain version (autograd through the table MLP and the staged
    # residuals), at the tolerances of the JAX package's tests/test_mega_bwd.py:
    # loss 5e-6 relative, gradients 1e-4 on the concatenation and 1e-3 each,
    # d_t 1e-3. The table gradients are held to the same two bounds.
    def k4_parity(g, w, h, seed, tag):
        kcfg = MLPGridConfig(dims=MLPDims(H=h))
        kp = mlp.init_params(kcfg.dims, seed=seed, device=dev)
        tabs = kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt))
        loss, grads = kbwd.table_loss_and_grad(g, w, *tabs)
        loss_p, grads_p = kbwd.table_loss_and_grad_plain(g, w, *tabs)
        torch.cuda.synchronize()
        report("mega_bwd", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), 5e-6, "rel")
        for name, x, y in zip(("dAB", "dCD", "dW2T", "db2"), grads, grads_p):
            report("mega_bwd", f"{tag} {name}", rel_l2_err(host(x), host(y)), 1e-3)
        report("mega_bwd", f"{tag} tables", rel_l2_err(host(cat(grads)), host(cat(grads_p))), 1e-4)
        lg, (gp, gt) = kbwd.mega_loss_and_grad(g, w, kcfg, kp, t)
        lg_p, (gp_p, gt_p) = kbwd.mega_loss_and_grad_plain(g, w, kcfg, kp, t)
        keys = sorted(gp)
        report("mega_bwd", f"{tag} params", rel_l2_err(host(cat([gp[k] for k in keys])),
                                                      host(cat([gp_p[k] for k in keys]))), 1e-4)
        report("mega_bwd", f"{tag} params each", max(rel_l2_err(host(gp[k]), host(gp_p[k])) for k in keys),
               1e-3)
        report("mega_bwd", f"{tag} d_t", rel(gt, gt_p), 1e-3, "rel")
        return max_abs_err(host(cat([loss, *grads])), host(cat([loss_p, *grads_p])))

    errs["mega_bwd"] = k4_parity(flagship, w, 128, 777, "128x96x96 H=128")
    w_k4 = PhysWeights(w_sigma=1.3, w_u=0.7)
    for periodic in (True, False):
        for scheme in ("central", "upwind"):
            for nz in (1, 2):
                g = GridSpec(40, 9, nz, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
                k4_parity(g, w_k4, 32, 3, f"40x9x{nz} {scheme} {'periodic' if periodic else 'clamp'} H=32")
    for dims, periodic, scheme in (((24, 13, 5), False, "upwind"), ((7, 3, 11), True, "central")):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        k4_parity(g, w_k4, 128, 3,
                  f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} H=128")

    for dims, periodic, scheme, h in mlp_edges(lambda h: kbwd.mega_fits(flagship, h)):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        k4_parity(g, w_k4, h, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} H={h}")

    # Autograd through K2 -> K1 and K3 (kernel forwards, staged backwards)
    # against plain autograd of the staged loss, gradients into the params
    # and t: 1e-4 on the concatenation, d_t 1e-3.
    g = GridSpec(24, 13, 5, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=False, scheme="upwind")

    def grads_of(loss_of):
        p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        tt = torch.tensor(t, device=dev, requires_grad=True)
        ls, lu = loss_of(p, tt)
        gr = torch.autograd.grad(ls + lu, [p[k] for k in sorted(p)] + [tt])
        return cat(gr[:-1]), gr[-1]

    ref_p, ref_t = grads_of(lambda p, tt: ops.loss_forward(g, w_k4, fields_mod.generate_fields(g, cfg, p, tt,
                                                                                               g.dt)))
    for name, fn in (("mlp", lambda p, tt: kmlp.fused_loss_pipeline(g, w_k4, cfg, p, tt)),
                     ("mega", lambda p, tt: kmega.mega_loss_pipeline(g, w_k4, cfg, p, tt))):
        gp_, gt_ = grads_of(fn)
        report(name, "24x13x5 upwind clamp autograd params", rel_l2_err(host(gp_), host(ref_p)), 1e-4)
        report(name, "24x13x5 upwind clamp autograd d_t", rel(gt_, ref_t), 1e-3, "rel")
    torch.cuda.empty_cache()

    # K5 vs its referee (the float32 forward's fields and ReLU masks from the
    # same encoding, autograd through the head, the staged residuals and the
    # fixed-order loss in float64) at the tolerances of the JAX package's
    # tests/test_mega_ngp.py: loss 1e-5 relative; every gradient 1e-4
    # (periodic) or 5e-3 (clamp); d_t 5e-3. Then the whole step (encoder
    # pull-back included) against the referee's step, every leaf at those
    # limits, and, as a looser witness, against float32 autograd of the
    # staged pipeline: loss 1e-5, the concatenated gradient 1e-4 / 5e-3,
    # each leaf 1e-3 / 5e-3 (that float32 plain version sums the nearly
    # cancelling -+g/(2dt) legs of dW2, b1 and W1's last row slice by slice,
    # K4's doctrine), d_t 5e-3. Tables are scaled to O(1) features and the
    # biases drawn at random, as that test does, so that no gradient sits
    # at the noise floor.
    w_k5 = PhysWeights(w_sigma=1.3, w_u=0.7)

    def ngp_conditioned(ncfg, seed):
        p = ngp.init_ngp_params(ncfg, seed=seed, device=dev)
        rng = np.random.Generator(np.random.MT19937(21))
        p["tables"] = tree.map_tree(lambda a: a * 2000.0, p["tables"])
        p["b1"] = torch.tensor(rng.standard_normal(ncfg.hidden) * 0.3, dtype=torch.float32, device=dev)
        p["b2"] = torch.tensor(rng.standard_normal(4) * 0.3, dtype=torch.float32, device=dev)
        return p

    def head_inputs(g, ncfg, p):
        """The kernel's inputs on the main path: the encoding [nz, LF, ny, nx],
        the head and the slice times."""
        enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g).contiguous()
        ts = fields_mod.slice_times(torch.full((), t, device=dev), g.dt)
        return enc, *(p[k].contiguous() for k in ("W1", "b1", "W2", "b2")), ts

    def leaf_names(tr, prefix=""):
        if isinstance(tr, dict):
            return [n for k in sorted(tr) for n in leaf_names(tr[k], f"{prefix}{k}/")]
        return [prefix.rstrip("/")]

    def worst_leaf(a, b):
        errs_ = {n: rel_l2_err(host(x), host(y)) for n, x, y in zip(leaf_names(a), tree.leaves(a), tree.leaves(b))}
        name = max(errs_, key=errs_.get)
        return name, errs_[name]

    def head_edges(fits):
        """(dims, periodic, scheme, NGPFieldConfig, tag) at the edges of the
        head core's tiling; H_max is the largest H that `fits` takes."""
        def h_max(lf):
            return max(h for h in range(1, 257) if fits(lf, h))

        def cfg_of(enc, h):
            return ngp.NGPFieldConfig(encoding=enc, hidden=h)

        hash4 = HashEncodingConfig(num_levels=2, max_resolution=16)
        hash64 = HashEncodingConfig(num_levels=32)
        four33 = FourierEncodingConfig(num_frequencies=5)
        dense16 = ngp.NGPFieldConfig().encoding
        return [
            ((24, 13, 5), False, "upwind", cfg_of(hash4, 8), "hash-only LF=4 H=8"),
            ((33, 9, 2), True, "central", cfg_of(four33, 64), "Fourier LF=33 H=64"),
            ((40, 9, 1), False, "central", cfg_of(hash64, h_max(64)), f"hash-only LF=64 H={h_max(64)}"),
            ((33, 9, 2), True, "upwind", cfg_of(dense16, h_max(16)), f"LF=16 H={h_max(16)}"),
            ((40, 9, 2), False, "upwind", cfg_of(dense16, 8), "LF=16 H=8"),
            ((7, 3, 1), True, "central", cfg_of(four33, h_max(33)), f"Fourier LF=33 H={h_max(33)}"),
        ]

    def k5_parity(g, ncfg, seed, tag):
        p = ngp_conditioned(ncfg, seed)
        lim = 1e-4 if g.periodic else 5e-3
        need_denc = any(x.numel() > 0 for x in tree.leaves(p["tables"]))
        args = head_inputs(g, ncfg, p)
        loss, cot = k5.head_loss_and_grad(g, w_k5, *args, need_denc=need_denc)
        loss_r, cot_r = k5.head_loss_and_grad_ref(g, w_k5, *args, need_denc=need_denc)
        torch.cuda.synchronize()
        report("mega_ngp", f"{tag} loss", max(rel(loss[k], loss_r[k]) for k in range(2)), 1e-5, "rel")
        for name, x, y in zip(("dEnc", "dW1", "db1", "dW2", "db2"), cot, cot_r):
            if x is not None:
                report("mega_ngp", f"{tag} {name}", rel_l2_err(host(x), host(y)), lim)
        lg, (gp, gt) = k5.ngp_loss_and_grad(g, w_k5, ncfg, p, t)
        lg_r, (gp_r, gt_r) = k5.ngp_loss_and_grad_ref(g, w_k5, ncfg, p, t)
        report("mega_ngp", f"{tag} step loss", rel(lg, lg_r), 1e-5, "rel")
        name, err = worst_leaf(gp, gp_r)
        report("mega_ngp", f"{tag} step worst leaf ({name})", err, lim)
        report("mega_ngp", f"{tag} step d_t", rel(gt, gt_r), 5e-3, "rel")
        del gp_r
        lg_p, (gp_p, gt_p) = k5.ngp_loss_and_grad_plain(g, w_k5, ncfg, p, t)
        report("mega_ngp", f"{tag} witness f32 autograd: step loss", rel(lg, lg_p), 1e-5, "rel")
        report("mega_ngp", f"{tag} witness f32 autograd: step params", rel_l2_err(host(cat(tree.leaves(gp))),
               host(cat(tree.leaves(gp_p)))), lim)
        name, err = worst_leaf(gp, gp_p)
        report("mega_ngp", f"{tag} witness f32 autograd: worst leaf ({name})", err, max(lim, 1e-3))
        report("mega_ngp", f"{tag} witness f32 autograd: d_t", rel(gt, gt_p), 5e-3, "rel")
        return max_abs_err(host(cat([loss, *(x for x in cot if x is not None)])),
                           host(cat([loss_r, *(y for y in cot_r if y is not None)])))

    ngp_flagship = ngp.NGPFieldConfig()
    errs["mega_ngp"] = k5_parity(flagship, ngp_flagship, 777, "128x96x96 NGPFieldConfig()")
    torch.cuda.empty_cache()
    for periodic in (True, False):
        for scheme in ("central", "upwind"):
            for nz in (1, 2):
                g = GridSpec(40, 9, nz, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
                k5_parity(g, ngp_flagship, 3, f"40x9x{nz} {scheme} {'periodic' if periodic else 'clamp'}")
    for dims, periodic, scheme, ncfg, what in (
        ((24, 13, 5), False, "upwind", ngp_flagship, "ragged"),
        ((24, 13, 5), True, "central", ngp.NGPFieldConfig(encoding=HashEncodingConfig()), "hash-only"),
        ((7, 3, 11), True, "upwind", ngp.NGPFieldConfig(encoding=FourierEncodingConfig()), "Fourier LF=39"),
        ((40, 9, 2), False, "central", ngp.NGPFieldConfig(encoding=FourierEncodingConfig(num_frequencies=4)),
         "Fourier LF=27"),
    ):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        k5_parity(g, ncfg, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} {what}")
    # The edges of the head core's tiling (csrc/ngp_head.cuh): LF 4, 33 and
    # 64 (padding to a multiple of 4, the dW1c tiles split over the row's
    # cells or two tiles a thread), H 8 and the largest the gate takes,
    # nx not a multiple of 32, nz 1 and 2, both schemes and boundaries.
    for dims, periodic, scheme, ncfg, what in head_edges(k5.ngp_fits):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        k5_parity(g, ncfg, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'} {what}")
    torch.cuda.empty_cache()

    # The hash grid encoder's kernel pair (csrc/hash_encode.cu) against its
    # plain ops on the card (hash_encoder.encode_grid_zcf_plain and the rows
    # form's), on K5's conditioned tables: ngp_hash_l16 (the benchmark's NGP
    # cells) and NGPFieldConfig(), at the flagship, a ragged grid and 256^3,
    # f32 and the bf16 tiers' fast encode. The forward differs from the
    # plain matmuls by their accumulation order (rel_l2 1e-6; the largest
    # gap over the largest value 1e-5), the pull-back sums in another order
    # (1e-5 a leaf, both, in f32); the fast pull-back rounds each pass's
    # float32 sums to bf16, so a sum an ulp from the plain one can round a
    # bf16 ulp (2^-8) away: 1e-4 a leaf, 4e-3 the largest gap over the
    # largest value. Two pull-backs give the same bits, and the rows form
    # on a shard's wrapped halo rows gives the whole encode's rows.
    def dev_rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(b.double()))

    def dev_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def encode_parity(g, enc_cfg, tag):
        p = ngp_conditioned(ngp.NGPFieldConfig(encoding=enc_cfg), 11)
        leaves = [x.detach().requires_grad_() for x in tree.leaves(p["tables"])]
        tab = tree.unflatten(p["tables"], leaves)
        rows = kbwd.halo_rows(g, g.nz // 4, g.nz // 4)
        for fast in (False, True):
            what = f"{tag} {'bf16' if fast else 'f32'}"
            enc = encoders.encode_grid_zcf(enc_cfg, tab, g, fast=fast)
            ct = torch.randn(enc.shape, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
            d1 = torch.autograd.grad(enc, leaves, ct, retain_graph=True)
            d2 = torch.autograd.grad(enc, leaves, ct)
            same = all(torch.equal(a, b) for a, b in zip(d1, d2))
            del d2
            rows_same = torch.equal(encoders.encode_grid_zcf_rows(enc_cfg, tab, g, rows, fast=fast), enc[rows])
            plain = hash_enc.encode_grid_zcf_plain(enc_cfg, tab, g, fast)
            report("hash_encode", f"{what} fwd", dev_rel(enc, plain.detach()), 1e-6)
            report("hash_encode", f"{what} fwd max", dev_max(enc, plain.detach()), 1e-5, "max/max")
            dp = torch.autograd.grad(plain, leaves, ct)
            del enc, plain, ct
            report("hash_encode", f"{what} pull-back worst leaf", max(dev_rel(a, b) for a, b in zip(d1, dp)),
                   1e-4 if fast else 1e-5)
            report("hash_encode", f"{what} pull-back worst leaf max", max(dev_max(a, b) for a, b in zip(d1, dp)),
                   4e-3 if fast else 1e-5, "max/max")
            print(f"phase 3 parity hash_encode {what}: two pull-backs bitwise equal {same}; rows form on halo rows "
                  f"{rows.tolist()[:3]}... bitwise the whole encode's {rows_same}")
            check(same and rows_same, f"hash_encode {what}: a repeatable pull-back and the rows form's bits")
            del d1, dp
        del p, leaves, tab
        torch.cuda.empty_cache()

    from phys_autodiff_tpu_torch.models import hash_encoder as hash_enc

    ngp_l16 = HashEncodingConfig(num_levels=16, base_resolution=16, max_resolution=256, log2_table_size=14,
                                 dense_oversubscribed=True)
    for g in (flagship, spec(45, 23, 13), spec(256, 256, 256)):
        for enc_cfg, name in ((ngp_l16, "ngp_hash_l16"), (ngp_flagship.encoding, "NGPFieldConfig()")):
            encode_parity(g, enc_cfg, f"{g.nx}x{g.ny}x{g.nz} {name}")

    # K6 and K7, the supervised-fit kernels, against their referees (the
    # float32 forward's outputs and ReLU masks, the error, the loss and
    # every derivative in float64) at the JAX package's contract
    # (tests/test_fit_kernel.py:62-68, :257-263): loss 1e-6 relative, every
    # gradient leaf 2e-5 (relative L2), d_t 1e-4; and, as a looser witness,
    # against float32 autograd (their plain versions): loss 1e-6, every leaf
    # 1e-4. The target is the JAX fit flagship's trig mix
    # (scripts/fit_bench.py:32-54) at t = 0.25; the NGP params are
    # conditioned as for K5 (tables scaled to O(1) features, random biases).
    def make_target(g):
        """scripts/fit_bench.py make_target: a multi-octave trig mix."""
        z, y, x = torch.meshgrid(*(torch.arange(n, device=dev) for n in g.shape), indexing="ij")
        xs, ys, zs = x / g.nx, y / g.ny, z / g.nz
        tp = 2 * math.pi
        sigma = (0.5 * torch.sin(tp * xs) * torch.cos(tp * ys) + 0.25 * torch.sin(3 * tp * (xs + zs))
                 + 0.125 * torch.cos(7 * tp * ys) * torch.sin(5 * tp * zs))
        u = torch.stack([0.4 * torch.cos(tp * zs) + 0.1 * torch.sin(4 * tp * ys),
                         0.3 * torch.sin(tp * xs) * torch.cos(3 * tp * zs),
                         0.2 * torch.cos(2 * tp * (xs + ys))])
        return sigma.float().contiguous(), u.float().contiguous()

    w_fit = PhysWeights(w_sigma=1.3, w_u=0.6)

    def k6_parity(g, h, seed, tag):
        kcfg = MLPGridConfig(dims=MLPDims(H=h))
        kp = mlp.init_params(kcfg.dims, seed=seed, device=dev)
        target = kfit.pack_target(g, *make_target(g))
        tabs = kmlp.fold_tables(g, kcfg, kp, torch.full((1,), t, device=dev))
        loss, grads = kfit.fit_table_loss_and_grad(g, w_fit, *tabs, target)
        loss_r, grads_r = kfit.fit_table_loss_and_grad_ref(g, w_fit, *tabs, target)
        torch.cuda.synchronize()
        report("fit", f"{tag} loss", max(rel(loss[k], loss_r[k]) for k in range(2)), 1e-6, "rel")
        for name, x, y in zip(("dAB", "dCD", "dW2T", "db2"), grads, grads_r):
            report("fit", f"{tag} {name}", rel_l2_err(host(x), host(y)), 2e-5)
        err = max_abs_err(host(cat([loss, *grads])), host(cat([loss_r, *grads_r])))
        del grads_r
        loss_p, grads_p = kfit.fit_table_loss_and_grad_plain(g, w_fit, *tabs, target)
        report("fit", f"{tag} witness f32 autograd: loss", max(rel(loss[k], loss_p[k]) for k in range(2)), 1e-6,
               "rel")
        report("fit", f"{tag} witness f32 autograd: worst table",
               max(rel_l2_err(host(x), host(y)) for x, y in zip(grads, grads_p)), 1e-4)
        del grads_p
        lg, (gp, gt) = kfit.fit_loss_and_grad(g, kcfg, kp, target, t, w_fit)
        lg_r, (gp_r, gt_r) = kfit.fit_loss_and_grad_ref(g, kcfg, kp, target, t, w_fit)
        report("fit", f"{tag} step loss", rel(lg, lg_r), 1e-6, "rel")
        name, e = worst_leaf(gp, gp_r)
        report("fit", f"{tag} step worst leaf ({name})", e, 2e-5)
        report("fit", f"{tag} step d_t", rel(gt, gt_r), 1e-4, "rel")
        return err

    def k7_parity(g, ncfg, seed, tag):
        p = ngp_conditioned(ncfg, seed)
        need_denc = any(x.numel() > 0 for x in tree.leaves(p["tables"]))
        target = kfit.pack_target(g, *make_target(g))
        enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g).contiguous()
        args = (enc, *(p[k].contiguous() for k in ("W1", "b1", "W2", "b2")), torch.full((), t, device=dev), target)
        loss, cot = kfit.ngp_fit_head_loss_and_grad(g, w_fit, *args, need_denc=need_denc)
        loss_r, cot_r = kfit.ngp_fit_head_loss_and_grad_ref(g, w_fit, *args, need_denc=need_denc)
        torch.cuda.synchronize()
        report("fit_ngp", f"{tag} loss", max(rel(loss[k], loss_r[k]) for k in range(2)), 1e-6, "rel")
        for name, x, y in zip(("dEnc", "dW1", "db1", "dW2", "db2"), cot, cot_r):
            if x is not None:
                report("fit_ngp", f"{tag} {name}", rel_l2_err(host(x), host(y)), 2e-5)
        err = max_abs_err(host(cat([loss, *(x for x in cot if x is not None)])),
                          host(cat([loss_r, *(y for y in cot_r if y is not None)])))
        del cot_r
        loss_p, cot_p = kfit.ngp_fit_head_loss_and_grad_plain(g, w_fit, *args, need_denc=need_denc)
        report("fit_ngp", f"{tag} witness f32 autograd: loss", max(rel(loss[k], loss_p[k]) for k in range(2)),
               1e-6, "rel")
        report("fit_ngp", f"{tag} witness f32 autograd: worst head leaf",
               max(rel_l2_err(host(x), host(y)) for x, y in zip(cot, cot_p) if x is not None), 1e-4)
        del cot_p, enc, args
        lg, (gp, gt) = kfit.ngp_fit_loss_and_grad(g, ncfg, p, target, t, w_fit)
        lg_r, (gp_r, gt_r) = kfit.ngp_fit_loss_and_grad_ref(g, ncfg, p, target, t, w_fit)
        report("fit_ngp", f"{tag} step loss", rel(lg, lg_r), 1e-6, "rel")
        name, e = worst_leaf(gp, gp_r)
        report("fit_ngp", f"{tag} step worst leaf ({name})", e, 2e-5)
        report("fit_ngp", f"{tag} step d_t", rel(gt, gt_r), 1e-4, "rel")
        return err

    errs["fit"] = k6_parity(flagship, 128, 0, "128x96x96 H=128")
    torch.cuda.empty_cache()
    errs["fit_ngp"] = k7_parity(flagship, ngp_flagship, 0, "128x96x96 NGPFieldConfig()")
    torch.cuda.empty_cache()
    for dims, periodic, h in (((40, 9, 1), True, 32), ((40, 9, 2), False, 64), ((24, 13, 5), False, 128),
                              ((7, 3, 11), True, 128)):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
        k6_parity(g, h, 3, f"{dims[0]}x{dims[1]}x{dims[2]} {'periodic' if periodic else 'clamp'} H={h}")
    for dims, periodic, _, h in mlp_edges(kfit.fit_fits):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
        k6_parity(g, h, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {'periodic' if periodic else 'clamp'} H={h}")
    for dims, periodic, ncfg, what in (
        ((40, 9, 1), True, ngp_flagship, "nz=1"),
        ((24, 13, 5), False, ngp_flagship, "ragged"),
        ((24, 13, 5), True, ngp.NGPFieldConfig(encoding=HashEncodingConfig()), "hash-only"),
        ((7, 3, 11), False, ngp.NGPFieldConfig(encoding=FourierEncodingConfig()), "Fourier LF=39"),
        ((40, 9, 2), True, ngp.NGPFieldConfig(encoding=FourierEncodingConfig(num_frequencies=4)), "Fourier LF=27"),
    ):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
        k7_parity(g, ncfg, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {'periodic' if periodic else 'clamp'} {what}")
    for dims, periodic, _, ncfg, what in head_edges(kfit.ngp_fit_fits):
        g = GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
        k7_parity(g, ncfg, 5, f"{dims[0]}x{dims[1]}x{dims[2]} {'periodic' if periodic else 'clamp'} {what}")
    torch.cuda.empty_cache()

    # The bf16 tier (csrc/mlp_mma.cuh: layer 2 on mma.sync, bf16 operands,
    # float32 sums): K2 (bf16, bf16x3), K3, K4 and K6 against their plain
    # bf16 versions (kernels/mlp.py _Layer2Bf16: the same rounded operands,
    # float32 matmuls) at the flagship and at the tiled core's edges with
    # each bf16 gate's top. Limits: fields 1e-5 relative L2 and losses 1e-4
    # relative (the tensor cores sum the same products in another order);
    # gradients 1e-3 relative L2 (gy is rounded to bf16 from float32
    # cotangents that differ from the plain ones in the last bits, so a few
    # operands round the other way). K3's loss equals K2 -> K1's to the bit
    # (one chain a field value), and no bf16 launch is the f32 kernel: bf16
    # fields lie more than 1e-4 from the f32 kernel's, bf16x3's (H <= 512)
    # nearer its own plain version than half their distance to f32, the bf16
    # gradients more than 1e-4 from K4's and K6's f32 ones.
    bf16_fields, bf16_loss, bf16_grad = 1e-5, 1e-4, 1e-3

    def k2_bf16_parity(g, kcfg, kp, tag, tiers=("bf16", "bf16x3")):
        ts_g = fields_mod.slice_times(t, g.dt)
        tabs = kmlp.fold_tables(g, kcfg, kp, ts_g)
        f32 = kmlp.generate_fields_fused(g, kcfg, kp, t)
        x32 = torch.cat([torch.stack(f32[:3]).reshape(-1), torch.stack(f32[3:]).reshape(-1)])
        for tier in tiers:
            sig_p, u_p = kmlp.mlp_tables_plain(*tabs, tier)
            fs = kmlp.generate_fields_fused(g, kcfg, kp, t, tier)
            pk = kmlp.generate_fields_fused_packed(g, kcfg, kp, t, tier)
            y1 = kmlp.grid_infer_fused(g, kcfg, kp, t, tier)
            s1, u1 = kmlp.mlp_tables_plain(*kmlp.fold_tables(g, kcfg, kp, ts_g[1:2]), tier)
            y1_p = torch.cat([s1[0][..., None], torch.movedim(u1[0], 0, -1)], dim=-1)
            torch.cuda.synchronize()
            split = torch.cat([torch.stack(fs[:3]).reshape(-1), torch.stack(fs[3:]).reshape(-1)])
            ref = torch.cat([sig_p.reshape(-1), u_p.reshape(-1)])
            pk_p = torch.cat([sig_p, u_p.reshape((-1,) + g.shape)], dim=0)
            for what, x, y in (("3-slice", split, ref), ("packed", pk, pk_p), ("grid_infer", y1, y1_p)):
                report(f"mlp {tier}", f"{tag} {what}", rel_l2_err(host(x), host(y)), bf16_fields)
            # bf16x3 misses only lo.lo (about 2^-18 of a product): past H = 512
            # the float32 sums' order moves the fields as much, so there it is
            # held to its plain version alone.
            d32, dp = rel_l2_err(host(split), host(x32)), rel_l2_err(host(split), host(ref))
            held = tier == "bf16" or kcfg.dims.H <= 512
            print(f"phase 3 parity mlp {tier:6s} {tag} vs the f32 kernel: rel_l2 {d32:.3e} "
                  f"({'> 1e-04' if tier == 'bf16' else f'> 2 x {dp:.3e} to its plain version'}"
                  f"{'' if held else ', not held past H = 512'})")
            check(not held or (d32 > 1e-4 if tier == "bf16" else (d32 > 2 * dp and not torch.equal(split, x32))),
                  f"K2 {tier} {tag} is not the f32 kernel")
            errs[f"mlp {tier}"] = max(errs[f"mlp {tier}"], max_abs_err(host(split), host(ref)))
            errs[f"mlp {tier} S=1"] = max(errs[f"mlp {tier} S=1"], max_abs_err(host(y1), host(y1_p)))
            del fs, pk, y1, split, ref, pk_p, sig_p, u_p
        del f32, x32
        torch.cuda.empty_cache()

    def k3_bf16_parity(g, kcfg, kp, tag):
        loss = kmega.mega_loss_pipeline(g, w, kcfg, kp, t, "bf16")
        tabs = kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt))
        loss_p = ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs, "bf16"))
        two = kmlp.fused_loss_pipeline(g, w, kcfg, kp, t, "bf16")
        torch.cuda.synchronize()
        report("mega bf16", f"{tag} loss vs plain", max(rel(loss[k], loss_p[k]) for k in range(2)), bf16_loss, "rel")
        same = all(float(loss[k]) == float(two[k]) for k in range(2))
        print(f"phase 3 parity mega bf16 {tag} loss bitwise equal to K2 bf16 -> K1's: {same}")
        check(same, f"K3 bf16 {tag}: the loss equals K2 bf16 -> K1's to the bit")
        errs["mega bf16"] = max(errs["mega bf16"], max(abs(float(loss[k]) - float(loss_p[k])) for k in range(2)))

    def k4_bf16_parity(g, w_, h, seed, tag):
        kcfg = MLPGridConfig(dims=MLPDims(H=h))
        kp = mlp.init_params(kcfg.dims, seed=seed, device=dev)
        tabs = kmlp.fold_tables(g, kcfg, kp, fields_mod.slice_times(t, g.dt))
        loss, grads = kbwd.table_loss_and_grad(g, w_, *tabs, "bf16")
        loss_p, grads_p = kbwd.table_loss_and_grad_plain(g, w_, *tabs, "bf16")
        # (past the f32 kernel's gate, H > 1300, the f32 plain version)
        grads_32 = (kbwd.table_loss_and_grad if kbwd.mega_fits(g, h) else kbwd.table_loss_and_grad_plain)(
            g, w_, *tabs)[1]
        torch.cuda.synchronize()
        report("mega_bwd bf16", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), bf16_loss, "rel")
        for name, x, y in zip(("dAB", "dCD", "dW2T", "db2"), grads, grads_p):
            report("mega_bwd bf16", f"{tag} {name}", rel_l2_err(host(x), host(y)), bf16_grad)
        report("mega_bwd bf16", f"{tag} tables", rel_l2_err(host(cat(grads)), host(cat(grads_p))), bf16_grad)
        # the fields and residual passes are K2 bf16's and K1's: the loss is
        # K2 bf16 -> K1's to the bit
        two = torch.stack(list(kmlp.fused_loss_pipeline(g, w_, kcfg, kp, t, "bf16")))
        same = torch.equal(loss, two)
        print(f"phase 3 parity mega_bwd bf16 {tag} loss bitwise equal to K2 bf16 -> K1's: {same}")
        check(same, f"K4 bf16 {tag}: the loss equals K2 bf16 -> K1's to the bit")
        d32 = rel_l2_err(host(cat(grads)), host(cat(grads_32)))
        print(f"phase 3 parity mega_bwd bf16 {tag} tables vs the f32 kernel: rel_l2 {d32:.3e} (> 1e-04)")
        check(d32 > 1e-4, f"K4 bf16 {tag} is not the f32 kernel")
        lg, (gp, _) = kbwd.mega_loss_and_grad(g, w_, kcfg, kp, t, "bf16")
        lg_p, (gp_p, _) = kbwd.mega_loss_and_grad_plain(g, w_, kcfg, kp, t, "bf16")
        keys = sorted(gp)
        report("mega_bwd bf16", f"{tag} params", rel_l2_err(host(cat([gp[k] for k in keys])),
                                                           host(cat([gp_p[k] for k in keys]))), bf16_grad)
        err = max_abs_err(host(cat([loss, *grads])), host(cat([loss_p, *grads_p])))
        errs["mega_bwd bf16"] = max(errs["mega_bwd bf16"], err)

    def k6_bf16_parity(g, h, seed, tag):
        kcfg = MLPGridConfig(dims=MLPDims(H=h))
        kp = mlp.init_params(kcfg.dims, seed=seed, device=dev)
        target = kfit.pack_target(g, *make_target(g))
        tabs = kmlp.fold_tables(g, kcfg, kp, torch.full((1,), t, device=dev))
        loss, grads = kfit.fit_table_loss_and_grad(g, w_fit, *tabs, target, "bf16")
        loss_p, grads_p = kfit.fit_table_loss_and_grad_plain(g, w_fit, *tabs, target, "bf16")
        _, grads_32 = kfit.fit_table_loss_and_grad(g, w_fit, *tabs, target)
        torch.cuda.synchronize()
        report("fit bf16", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), bf16_loss, "rel")
        for name, x, y in zip(("dAB", "dCD", "dW2T", "db2"), grads, grads_p):
            report("fit bf16", f"{tag} {name}", rel_l2_err(host(x), host(y)), bf16_grad)
        d32 = rel_l2_err(host(cat(grads)), host(cat(grads_32)))
        print(f"phase 3 parity fit bf16 {tag} tables vs the f32 kernel: rel_l2 {d32:.3e} (> 1e-04)")
        check(d32 > 1e-4, f"K6 bf16 {tag} is not the f32 kernel")
        lg, (gp, _) = kfit.fit_loss_and_grad(g, kcfg, kp, target, t, w_fit, "bf16")
        lg_p, (gp_p, _) = kfit._loss_and_grad(g, kcfg, kp, target, t, w_fit, "bf16",
                                              kfit.fit_table_loss_and_grad_plain)
        report("fit bf16", f"{tag} step loss", rel(lg, lg_p), bf16_loss, "rel")
        name, e = worst_leaf(gp, gp_p)
        report("fit bf16", f"{tag} step worst leaf ({name})", e, bf16_grad)
        errs["fit bf16"] = max(errs["fit bf16"], max_abs_err(host(cat([loss, *grads])), host(cat([loss_p, *grads_p]))))

    k2_bf16_parity(flagship, cfg, params, "128x96x96 H=128")
    k3_bf16_parity(flagship, cfg, params, "128x96x96 H=128")
    k4_bf16_parity(flagship, w, 128, 777, "128x96x96 H=128")
    k6_bf16_parity(flagship, 128, 0, "128x96x96 H=128")
    torch.cuda.empty_cache()
    for fits, run in ((lambda h: kmlp.mlp_fits(h, "bf16"), "bf16"), (lambda h: kmlp.mlp_fits(h, "bf16x3"), "bf16x3"),
                      (lambda h: kmega.mega_fwd_fits(flagship, h, "bf16"), "k3"),
                      (lambda h: kbwd.mega_fits(flagship, h, "bf16"), "k4"), (lambda h: kfit.fit_fits(h, "bf16"), "k6")):
        for dims, periodic, scheme, h in mlp_edges(fits):
            g = edge_spec(dims, periodic, scheme)
            tag = edge_tag(dims, periodic, scheme, h)
            if run in ("bf16", "bf16x3", "k3"):
                kcfg = MLPGridConfig(dims=MLPDims(H=h))
                kp = mlp.init_params(kcfg.dims, seed=5, device=dev)
                if run == "k3":
                    k3_bf16_parity(g, kcfg, kp, tag)
                else:
                    k2_bf16_parity(g, kcfg, kp, tag, (run,))
            elif run == "k4":
                k4_bf16_parity(g, w_k4, h, 5, tag)
            else:
                k6_bf16_parity(g, h, 5, tag)
    # K2 bf16 / bf16x3 (S = 3 and 1) and K4 bf16's fields pass at the first H
    # of each depth of the forward's AB rings at either slice count
    # (kernels/mlp.ring_stages: 2 stages or none, with two blocks an SM and
    # then with one), each on a small clamp grid whose nx is not a multiple
    # of 4 (no ring: AB read from device memory) and on one whose nx is (the
    # ring's 16-byte copies, the second tile of 16 cells past nx zero-filled).
    g_r = (edge_spec((33, 9, 3), False, "upwind"), edge_spec((24, 5, 2), True, "central"))
    for tier, k4_too in (("bf16", True), ("bf16x3", False)):
        firsts = []
        for s_ in (3, 1):
            depth = None
            for h in range(1, _build.gate_top(lambda x: kmlp.mlp_fits(x, tier)) + 1):
                ns = kmlp.ring_stages(kmlp.fields_fixed_bytes(h, s_, tier), g_r[1].nx)
                if ns != depth:
                    depth = ns
                    firsts.append(h)
        for h in sorted(set(firsts)):
            kcfg = MLPGridConfig(dims=MLPDims(H=h))
            for gk in g_r:
                rings = ", ".join(f"S = {s_}: {kmlp.ring_stages(kmlp.fields_fixed_bytes(h, s_, tier), gk.nx)}"
                                  for s_ in (3, 1))
                tag = f"{edge_tag((gk.nx, gk.ny, gk.nz), gk.periodic, gk.scheme, h)} (ring stages {rings})"
                k2_bf16_parity(gk, kcfg, mlp.init_params(kcfg.dims, seed=5, device=dev), tag, (tier,))
                if k4_too and kbwd.mega_fits(gk, h, "bf16"):
                    k4_bf16_parity(gk, w_k4, h, 5, tag)
    for periodic in (True, False):
        for scheme in ("central", "upwind"):
            for nz in (1, 2):
                g = GridSpec(40, 9, nz, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
                k4_bf16_parity(g, w_k4, 32, 3, f"40x9x{nz} {scheme} {'periodic' if periodic else 'clamp'} H=32")
    # K6 bf16 also at the grids and widths of the NGP tiers' edges (tier_edges:
    # H 1, 63, 65 and the head core's tops), and where each of its chunk
    # depths begins (kernels/fit.fit_zrows_bf16: 24, 16, 8 and 4 rows).
    for dims, periodic, scheme, _, h in tier_edges(kfit.ngp_fit_fits):
        k6_bf16_parity(edge_spec(dims, periodic, scheme), h, 5, edge_tag(dims, periodic, scheme, h))
    for h in (225, 449, 977):
        k6_bf16_parity(edge_spec((33, 9, 40), False, "upwind"), h, 5, edge_tag((33, 9, 40), False, "upwind", h))
    torch.cuda.empty_cache()

    # The NGP path's reduced tiers (K5 bf16 and f32_fastbwd, K7 bf16) and
    # K1's bf16-I/O entry points against their plain versions.
    errs.update(ngp_tier_parity(report, check, dev, flagship, t, ngp_conditioned, make_target))
    torch.cuda.empty_cache()
    errs.update(k1_low_parity(report, check, dev, [flagship] + [
        GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic, scheme=scheme)
        for dims in ((40, 9, 1), (24, 13, 5), (7, 3, 11), (33, 17, 2), (1, 1, 1))
        for periodic, scheme in ((True, "central"), (False, "upwind"))]))

    # The z-sharded path: the shard-local builds of K4-K7 on every shard of
    # the 2- and 4-way splits against their plain versions and, summed,
    # against the whole-grid kernels; the sharded steps over a world-size-1
    # NCCL group against the single-device steps; F12, the fused step past
    # K4's gate.
    errs.update(shard_parity(report, check, dev, flagship, t, ngp_conditioned, make_target))
    torch.cuda.empty_cache()
    sharded_steps(check, dev, flagship, t, ngp_conditioned, make_target)
    f12_parity(check, dev, spec(128, 96, 32), t)

    # K8 (one semi-Lagrangian step), K8c (the step from six weight planes) and
    # P1 (the launch-floor probe) against their plain versions: bitwise.
    big = spec(256, 256, 256)
    errs["transport"], errs["transport_pre"], errs["probe"] = transport_parity(
        report, dev, [flagship, dataclasses.replace(flagship, periodic=False)],
        [GridSpec(*dims, hx=0.3, hy=0.35, hz=0.4, dt=1e-2, periodic=periodic)
         for dims in ((40, 9, 1), (40, 9, 2), (24, 13, 5), (7, 3, 11), (30, 9, 3), (33, 17, 5), (4, 8, 3),
                      (36, 9, 40), (64, 16, 13), (1, 1, 1), (100, 1100, 2), (36, 300, 40), (33, 120, 60))
         for periodic in (True, False)],
        [big, dataclasses.replace(big, periodic=False)])
    # K8's slab form on every shard of the 2-, 4- and 8-way splits (bitwise
    # the whole-grid K8 and its plain twin), then the sharded apps over the
    # world-size-1 NCCL group against the single-device ones.
    errs["transport slab"] = transport_slab_parity(report, dev, [flagship, dataclasses.replace(flagship, periodic=False)])
    sharded_apps_parity(check, dev, flagship, t)
    torch.cuda.empty_cache()
    # utils/checks.checked around the K3 and K2 -> K1 losses: clean, and
    # with a NaN planted in W2.
    checks_parity(check, dev, flagship, w, cfg, params, t)
    torch.cuda.empty_cache()

    # ---- 4. the slice end to end -----------------------------------------
    g = flagship
    _build.reset_launches()
    fields = kmlp.generate_fields_fused(g, cfg, params, t)      # README quick start
    r_sigma, r_u = kres.residuals_fused(g, fields)
    readme = ops.loss_terms(g, w, r_sigma, r_u)
    fused = kmlp.fused_loss_pipeline(g, w, cfg, params, t)       # K2 -> K1 partials
    mega = kmega.mega_loss_pipeline(g, w, cfg, params, t)        # K3
    fn, args = entry(dev)                                        # the flagship entry
    entry_loss = fn(*args)
    packed = kmlp.generate_fields_fused_packed(g, cfg, params, t)
    headline = kres.residuals_fused_packed(g, packed)            # the bench headline op
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"phase 4 slice launches: {launches}")
    for name in ("residuals", "mlp", "mega"):
        check(launches[name] > 0, f"kernel {name} was not launched on the forward slice")
    # One launch a call: K2 in the README fields, fused_loss_pipeline and the
    # packed fields; K3 in mega_loss_pipeline and entry().
    check(launches["mlp"] == 3 and launches["mega"] == 2, "K2 and K3 launch once a call")

    plain = ops.loss_forward(g, w, fields_mod.generate_fields(g, cfg, params, t, g.dt))
    ls_o, lu_o = oracle.loss_forward(g, w, *[host(x) for x in fields])
    check(tuple(headline.shape) == (4,) + g.shape, "headline output shape")
    check(bool(torch.isfinite(headline).all()), "headline residuals finite")
    check(bool(torch.isfinite(entry_loss)), "entry loss finite")
    for name, arm in (("readme", readme), ("fused", fused), ("mega", mega)):
        check(all(bool(torch.isfinite(x)) for x in arm), f"{name} loss finite")
        d_plain = max(rel(arm[k], plain[k]) for k in range(2))
        d_oracle = max(rel(arm[0], ls_o), rel(arm[1], lu_o))
        print(f"phase 4 slice {name:6s}: L_sigma {float(arm[0]):.9g} L_u {float(arm[1]):.9g} "
              f"rel vs plain {d_plain:.3e} (<= 1e-5), vs f64 oracle {d_oracle:.3e} (<= 1e-6)")
        check(d_plain <= 1e-5, f"{name} vs plain path")
        check(d_oracle <= 1e-6, f"{name} vs f64 oracle")
    print(f"phase 4 slice plain : L_sigma {float(plain[0]):.9g} L_u {float(plain[1]):.9g}; "
          f"oracle {float(ls_o):.9g} {float(lu_o):.9g}; entry 128x64x64 loss {float(entry_loss):.9g}")
    # Determinism and the shared forward: K3 again gives the same bits, and
    # K2's one slice (grid_infer) is the t slice of its three to the bit.
    mega_2 = kmega.mega_loss_pipeline(g, w, cfg, params, t)
    y1 = kmlp.grid_infer_fused(g, cfg, params, t)
    t_slice = torch.cat([fields.sigma_t[..., None], torch.movedim(fields.u_t, 0, -1)], dim=-1)
    same_mega = all(torch.equal(a, b) for a, b in zip(mega, mega_2))
    same_t = torch.equal(y1, t_slice)
    print(f"phase 4 slice K3 rerun bitwise equal {same_mega}; K2 grid_infer (S = 1) equals the t slice of its "
          f"S = 3 fields bitwise {same_t}; K3's loss equals K2 -> K1's bitwise "
          f"{all(float(a) == float(b) for a, b in zip(mega, fused))}")
    check(same_mega and same_t, "K3 rerun and K2's S = 1 t slice give the same bits")
    del y1, t_slice
    del fields, r_sigma, r_u, packed, headline
    torch.cuda.empty_cache()

    # The training slice: fit() for 5 adam steps (lr 1e-3) from the flagship
    # params with use_fused=True (one K4 call per step), and the same steps
    # from the same params by plain autograd of the staged loss on the card.
    # Step 1 sees the same params in both arms (forward-loss class, 1e-5);
    # later steps follow two f32 gradient paths (1e-4), and the params'
    # displacement from the start agrees within 1e-3.
    steps = 5
    tcfg = TrainConfig(steps=steps, learning_rate=1e-3, seed=777, t=t, log_every=1, use_fused=True)
    _build.reset_launches()
    state_f, hist_f, sec_f = fit(g, w, cfg, tcfg, state=state_from_params(tcfg, params))
    torch.cuda.synchronize()
    train_launches = dict(_build.LAUNCHES)
    print(f"phase 4 train launches (fit, use_fused=True, {steps} steps): {train_launches}")
    check(train_launches["mega_bwd"] == steps, "mega_bwd launched once per fused training step")
    # One seed fixes the trajectory: the same 5 steps again give the same
    # bits (K4 sums in a fixed order, with no atomics).
    state_2, hist_2, _ = fit(g, w, cfg, tcfg, state=state_from_params(tcfg, params))
    same_loss = [lo for _, lo in hist_f] == [lo for _, lo in hist_2]
    same_params = all(torch.equal(state_f.params[k], state_2.params[k]) for k in state_f.params)
    print(f"phase 4 train rerun of the {steps} K4 steps from the same seed: losses bitwise equal {same_loss}, "
          f"params bitwise equal {same_params}")
    check(same_loss and same_params, "two runs of the K4 training steps give the same bits")
    del state_2
    # The same for 5 fit steps through K6 (make_fit_step, engine mega) on the
    # fit flagship's target at the CLI's MLP settings (H = 128, lr 3e-3).
    sig_f, u_f = make_target(g)
    fit_runs = []
    for _ in range(2):
        fstep, fstate = ff.make_fit_step(g, cfg, [ff.FitTarget(sig_f, u_f, t)], TrainConfig(learning_rate=3e-3),
                                         engine="mega", device=dev)
        _build.reset_launches()
        flosses = []
        for _ in range(steps):
            fstate, floss = fstep(fstate)
            flosses.append(floss)
        torch.cuda.synchronize()
        check(_build.LAUNCHES["fit"] == steps, "fit launched once per MLP fit step")
        fit_runs.append((flosses, fstate.params))
    same_loss = all(torch.equal(a, b) for a, b in zip(fit_runs[0][0], fit_runs[1][0]))
    same_params = all(torch.equal(fit_runs[0][1][k], fit_runs[1][1][k]) for k in fit_runs[0][1])
    print(f"phase 4 fit rerun of {steps} K6 steps (launches {steps} in {steps} each): losses "
          f"{float(fit_runs[0][0][0]):.9g} -> {float(fit_runs[0][0][-1]):.9g} bitwise equal {same_loss}, params "
          f"bitwise equal {same_params}")
    check(same_loss and same_params, "two runs of the K6 fit steps give the same bits")
    del sig_f, u_f, fit_runs, fstate
    tcfg_p = dataclasses.replace(tcfg, use_fused=False)
    state_p, hist_p, sec_p = fit(g, w, cfg, tcfg_p, state=state_from_params(tcfg_p, params))
    for (i, lf), (_, lp) in zip(hist_f, hist_p):
        limit = 1e-5 if i == 1 else 1e-4
        d = abs(lf - lp) / abs(lp)
        print(f"phase 4 train step {i}: loss K4 {lf:.9g} plain {lp:.9g} rel {d:.3e} (<= {limit:.0e})")
        check(np.isfinite(lf) and d <= limit, f"training step {i} loss")
    keys = sorted(params)
    start = cat([params[k] for k in keys])
    moved_f = cat([state_f.params[k].detach() for k in keys]) - start
    moved_p = cat([state_p.params[k].detach() for k in keys]) - start
    check(bool(torch.isfinite(moved_f).all()), "trained params finite")
    d_moved = rel_l2_err(host(moved_f), host(moved_p))
    print(f"phase 4 train params moved: rel {d_moved:.3e} (<= 1e-3) K4 vs plain; fit wall "
          f"{sec_f:.3f} s (K4) vs {sec_p:.3f} s (plain), {steps} steps incl. first-call set-up")
    check(d_moved <= 1e-3, "trained params K4 vs plain")
    # loss_fn(use_fused=True): the K3 forward with the K4 backward (autograd)
    _build.reset_launches()
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    fused_loss = loss_fn(g, w, cfg, p, t, use_fused=True)
    fused_loss.backward()
    torch.cuda.synchronize()
    fused_launches = dict(_build.LAUNCHES)
    print(f"phase 4 train launches (loss_fn use_fused=True + backward): {fused_launches}")
    check(fused_launches["mega"] == 1 and fused_launches["mega_bwd"] == 1, "K3 forward, K4 backward")
    _, (gp_ref, _) = kbwd.mega_loss_and_grad(g, w, cfg, params, t)
    d_fn = rel_l2_err(host(cat([p[k].grad for k in keys])), host(cat([gp_ref[k] for k in keys])))
    print(f"phase 4 train loss_fn(use_fused=True) grads vs mega_loss_and_grad: rel {d_fn:.3e} (<= 1e-6)")
    check(d_fn <= 1e-6, "fused loss backward")
    del state_f, state_p, p
    torch.cuda.empty_cache()

    # The bf16 slice (the H = 128 MLP at the flagship, precision="bf16"):
    # serving through grid_infer_fused (one K2 bf16 launch; bf16x3 too), both
    # forward losses (K2 bf16 -> K1 f32, and K3 bf16: equal to the bit, and
    # 1e-5 from the plain bf16 loss), then 5 training steps through
    # make_train_step (K4 bf16 once a step) and 5 fit steps through K6 bf16,
    # each run twice from one seed (bitwise equal) and held step by step to
    # the same steps through the plain bf16 versions: step 1's loss 1e-5,
    # later ones 1e-4, the params' displacement 1e-3 (the f32 slice's
    # limits).
    def bf16_only(got, want, what):
        """The launch counts of a bf16 run: `want` and nothing of the f32 kernels."""
        extra = {k: v for k, v in got.items() if v and k not in want}
        check(all(got[k] == v for k, v in want.items()) and not extra, f"{what}: launches {got}")

    _build.reset_launches()
    y_b = kmlp.grid_infer_fused(g, cfg, params, t, "bf16")
    torch.cuda.synchronize()
    serve_b = dict(_build.LAUNCHES)
    bf16_only(serve_b, {"mlp bf16": 1}, "grid_infer_fused bf16")
    _build.reset_launches()
    y_x3 = kmlp.grid_infer_fused(g, cfg, params, t, "bf16x3")
    torch.cuda.synchronize()
    serve_x3 = dict(_build.LAUNCHES)
    bf16_only(serve_x3, {"mlp bf16x3": 1}, "grid_infer_fused bf16x3")
    _build.reset_launches()
    fused_b = kmlp.fused_loss_pipeline(g, w, cfg, params, t, "bf16")
    mega_b = kmega.mega_loss_pipeline(g, w, cfg, params, t, "bf16")
    torch.cuda.synchronize()
    loss_b_launches = dict(_build.LAUNCHES)
    bf16_only(loss_b_launches, {"mlp bf16": 1, "residuals": 1, "mega bf16": 1}, "the bf16 forward losses")
    s1, u1 = kmlp.mlp_tables_plain(*kmlp.fold_tables(g, cfg, params, ts[1:2]), "bf16")
    y_p = torch.cat([s1[0][..., None], torch.movedim(u1[0], 0, -1)], dim=-1)
    plain_b = ops.sum_partials(g, w, kmega.mega_partials_plain(g, *kmlp.fold_tables(g, cfg, params, ts), "bf16"))
    d_serve = rel_l2_err(host(y_b), host(y_p))
    same_b = all(float(a) == float(b) for a, b in zip(fused_b, mega_b))
    d_loss_b = max(rel(mega_b[k], plain_b[k]) for k in range(2))
    d_f32 = max(rel(mega_b[k], mega[k]) for k in range(2))
    print(f"phase 4 bf16 slice launches: grid_infer bf16 {serve_b['mlp bf16']}, bf16x3 {serve_x3['mlp bf16x3']}; "
          f"the two forward losses {loss_b_launches}; grid_infer bf16 vs plain rel_l2 {d_serve:.3e} (<= 1e-5); "
          f"L_sigma {float(mega_b[0]):.9g} L_u {float(mega_b[1]):.9g}: K3 bf16 equals K2 bf16 -> K1 bitwise "
          f"{same_b}, vs plain bf16 {d_loss_b:.3e} (<= 1e-5), vs the f32 loss {d_f32:.3e}")
    check(bool(torch.isfinite(y_b).all()) and bool(torch.isfinite(y_x3).all()), "bf16 fields finite")
    check(d_serve <= 1e-5 and same_b and d_loss_b <= 1e-5, "the bf16 forward slice")
    del y_b, y_x3, s1, u1, y_p
    tcfg_b = dataclasses.replace(tcfg, precision="bf16")
    runs_b = []
    for _ in range(2):
        _build.reset_launches()
        st_b, hist_b, sec_b = fit(g, w, cfg, tcfg_b, state=state_from_params(tcfg_b, params))
        torch.cuda.synchronize()
        train_b_launches = dict(_build.LAUNCHES)
        bf16_only(train_b_launches, {"mega_bwd bf16": steps}, "the bf16 training steps")
        runs_b.append((hist_b, st_b.params))
    same_loss = runs_b[0][0] == runs_b[1][0]
    same_params = all(torch.equal(runs_b[0][1][k], runs_b[1][1][k]) for k in keys)
    st_p = state_from_params(tcfg_b, params)
    sched = make_schedule(tcfg_b)
    hist_p = []
    for _ in range(steps):
        lp, (gp, _) = kbwd.mega_loss_and_grad_plain(g, w, cfg, st_p.params, t, "bf16")
        st_p = _apply_grads(tcfg_b, sched, st_p, gp)
        hist_p.append(float(lp))
    for (i, lf), lp in zip(runs_b[0][0], hist_p):
        limit = 1e-5 if i == 1 else 1e-4
        d = abs(lf - lp) / abs(lp)
        print(f"phase 4 train bf16 step {i}: loss K4 bf16 {lf:.9g} plain bf16 {lp:.9g} rel {d:.3e} (<= {limit:.0e})")
        check(np.isfinite(lf) and d <= limit, f"bf16 training step {i} loss")
    moved_b = cat([runs_b[0][1][k].detach() for k in keys]) - start
    moved_p = cat([st_p.params[k].detach() for k in keys]) - start
    d_moved = rel_l2_err(host(moved_b), host(moved_p))
    print(f"phase 4 train bf16: launches {train_b_launches} a run; rerun from the same seed: losses bitwise equal "
          f"{same_loss}, params bitwise equal {same_params}; params moved rel {d_moved:.3e} (<= 1e-3) vs plain bf16")
    check(same_loss and same_params and d_moved <= 1e-3, "the bf16 training steps")
    del runs_b, st_b, st_p
    sig_f, u_f = make_target(g)
    fit_tcfg_b = TrainConfig(learning_rate=3e-3, precision="bf16")
    fit_b = []
    for _ in range(2):
        fstep, fstate = ff.make_fit_step(g, cfg, [ff.FitTarget(sig_f, u_f, t)], fit_tcfg_b, engine="mega",
                                         device=dev)
        _build.reset_launches()
        flosses = []
        for _ in range(steps):
            fstate, floss = fstep(fstate)
            flosses.append(floss)
        torch.cuda.synchronize()
        fit_b_launches = dict(_build.LAUNCHES)
        bf16_only(fit_b_launches, {"fit bf16": steps}, "the bf16 fit steps")
        fit_b.append((flosses, fstate.params))
    same_loss = all(torch.equal(a, b) for a, b in zip(fit_b[0][0], fit_b[1][0]))
    same_params = all(torch.equal(fit_b[0][1][k], fit_b[1][1][k]) for k in keys)
    f_p = state_from_params(fit_tcfg_b, ff.init_any(cfg, seed=fit_tcfg_b.seed, device=dev))
    f_start = cat([f_p.params[k].detach().clone() for k in keys])
    sched = make_schedule(fit_tcfg_b)
    target_f = kfit.pack_target(g, sig_f, u_f)
    for i in range(steps):
        lp, (gp, _) = kfit._loss_and_grad(g, cfg, f_p.params, target_f, t, PhysWeights(), "bf16",
                                          kfit.fit_table_loss_and_grad_plain)
        f_p = _apply_grads(fit_tcfg_b, sched, f_p, gp)
        limit = 1e-5 if i == 0 else 1e-4
        d = rel(fit_b[0][0][i], lp)
        print(f"phase 4 fit bf16 step {i + 1}: loss K6 bf16 {float(fit_b[0][0][i]):.9g} plain bf16 {float(lp):.9g} "
              f"rel {d:.3e} (<= {limit:.0e})")
        check(d <= limit, f"bf16 fit step {i + 1} loss")
    d_moved = rel_l2_err(host(cat([fit_b[0][1][k] for k in keys]) - f_start),
                         host(cat([f_p.params[k].detach() for k in keys]) - f_start))
    print(f"phase 4 fit bf16: launches {fit_b_launches} a run; rerun from the same seed: losses bitwise equal "
          f"{same_loss}, params bitwise equal {same_params}; params moved rel {d_moved:.3e} (<= 1e-3) vs plain bf16")
    check(same_loss and same_params and d_moved <= 1e-3, "the bf16 fit steps")
    # loss_fn(use_fused=True) in bf16: the K3 bf16 forward with the K4 bf16
    # backward (autograd), whose gradients are K4 bf16's own (1e-6, as f32).
    _build.reset_launches()
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss_fn(g, w, cfg, p, t, use_fused=True, precision="bf16").backward()
    torch.cuda.synchronize()
    fused_b_launches = dict(_build.LAUNCHES)
    bf16_only(fused_b_launches, {"mega bf16": 1, "mega_bwd bf16": 1}, "loss_fn(use_fused=True) bf16 + backward")
    _, (gp_ref, _) = kbwd.mega_loss_and_grad(g, w, cfg, params, t, "bf16")
    d_fn = rel_l2_err(host(cat([p[k].grad for k in keys])), host(cat([gp_ref[k] for k in keys])))
    print(f"phase 4 train bf16 loss_fn(use_fused=True): launches {fused_b_launches}; grads vs "
          f"mega_loss_and_grad bf16 rel {d_fn:.3e} (<= 1e-6)")
    check(d_fn <= 1e-6, "bf16 fused loss backward")
    del p, gp_ref
    # The composite bf16 fit (phys_weight 0.1): K6 bf16 and K4 bf16 once a
    # step each, from one seed twice (bitwise), held to the plain bf16
    # composite: step 1's loss 1e-5, step 2's 1e-4.
    pw = 0.1
    comp = []
    for _ in range(2):
        cstep, cstate = ff.make_fit_step(g, cfg, [ff.FitTarget(sig_f, u_f, t)], fit_tcfg_b, phys_weight=pw,
                                         engine="mega", device=dev)
        _build.reset_launches()
        closses = []
        for _ in range(2):
            cstate, closs = cstep(cstate)
            closses.append(closs)
        torch.cuda.synchronize()
        comp_launches = dict(_build.LAUNCHES)
        bf16_only(comp_launches, {"fit bf16": 2, "mega_bwd bf16": 2}, "the composite bf16 fit steps")
        comp.append((closses, cstate.params))
    same_loss = all(torch.equal(a, b) for a, b in zip(comp[0][0], comp[1][0]))
    same_params = all(torch.equal(comp[0][1][k], comp[1][1][k]) for k in keys)
    c_p = state_from_params(fit_tcfg_b, ff.init_any(cfg, seed=fit_tcfg_b.seed, device=dev))
    pw32 = float(np.float32(pw))
    for i in range(2):
        ld, (gd, _) = kfit._loss_and_grad(g, cfg, c_p.params, target_f, t, PhysWeights(), "bf16",
                                          kfit.fit_table_loss_and_grad_plain)
        lq, (gq, _) = kbwd.mega_loss_and_grad_plain(g, PhysWeights(), cfg, c_p.params, t, "bf16")
        c_p = _apply_grads(fit_tcfg_b, sched, c_p, {k: gd[k] + pw32 * gq[k] for k in gd})
        lp = ld + pw32 * lq
        limit = 1e-5 if i == 0 else 1e-4
        d = rel(comp[0][0][i], lp)
        print(f"phase 4 fit bf16 composite step {i + 1}: loss K6 + K4 bf16 {float(comp[0][0][i]):.9g} plain bf16 "
              f"{float(lp):.9g} rel {d:.3e} (<= {limit:.0e})")
        check(bool(torch.isfinite(comp[0][0][i])) and d <= limit, f"composite bf16 fit step {i + 1} loss")
    print(f"phase 4 fit bf16 composite: launches {comp_launches} a run; rerun from the same seed: losses bitwise "
          f"equal {same_loss}, params bitwise equal {same_params}")
    check(same_loss and same_params, "the composite bf16 fit steps")
    # bf16x3 at S = 3 lies on no user path (the losses and slab_grad take
    # bf16x3 to f32): its main-path count is 0 (phases 3 and 5 launch it).
    bf16_launches = {"mlp bf16": loss_b_launches["mlp bf16"], "mlp bf16x3": 0,
                     "mlp bf16 S=1": serve_b["mlp bf16"], "mlp bf16x3 S=1": serve_x3["mlp bf16x3"],
                     "mega bf16": loss_b_launches["mega bf16"], "mega_bwd bf16": train_b_launches["mega_bwd bf16"],
                     "fit bf16": fit_b_launches["fit bf16"]}
    del fit_b, f_p, fstate, sig_f, u_f, target_f, comp, c_p, cstate
    torch.cuda.empty_cache()

    # The encoded-field training slice at full width: NGPFieldConfig() (hash
    # L=8, F=2, T=2^14, levels 29-128 dense, LF=16, H=64) on 128x96x96, from
    # init_ngp_params(seed=777): 5 adam steps (lr 1e-3, t fixed) of
    # make_ngp_train_step(backward="mega"), K5 once per step. Each step is
    # held, at the params it started from, to phase 3's referee
    # (ngp_loss_and_grad_ref): loss 1e-5, the concatenated gradient 1e-4
    # (single leaves are not: at this init b1's gradient sits at the float32
    # noise floor, 4e-8 against W1's 0.5); and, as a looser witness, to
    # float32 autograd (ngp_loss_and_grad_plain) at 1e-4 each: its loss sums
    # in another order and read 1.8e-6 to 1.1e-5 from K5's at step 5 over
    # four runs, while K5's loss equals the referee's in phase 3. The
    # trajectory itself varies from run to run (the encoder's pull-back
    # scatters with atomics). The same 5 steps by plain autograd
    # from the same params are printed beside them; only step 1 starts from
    # the same params (1e-5): Adam moves every parameter by about lr
    # whatever its gradient, so noise-floor leaves part the two trajectories.
    ncfg = ngp_flagship
    p0 = ngp.init_ngp_params(ncfg, seed=777, device=dev)
    ncfg_train = TrainConfig(learning_rate=1e-3, seed=777, t=t)
    step_m, st_m = make_ngp_train_step(g, w, ncfg, ncfg_train, p0, backward="mega")
    snapshots, losses_m = [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        snapshots.append(tree.map_tree(lambda x: x.detach().clone(), st_m.params))
        st_m, loss_m = step_m(st_m)
        losses_m.append(loss_m)
    torch.cuda.synchronize()
    sec_m = time.perf_counter() - t0
    ngp_launches = dict(_build.LAUNCHES)
    print(f"phase 4 ngp launches (make_ngp_train_step mega, {steps} steps): {ngp_launches}")
    check(ngp_launches["mega_ngp"] == steps, "mega_ngp launched once per NGP training step")
    check(all(bool(torch.isfinite(x).all()) for x in tree.leaves(st_m.params)), "trained NGP params finite")
    # One seed fixes the trajectory: the same 5 steps again from p0 give the
    # same bits (K5 sums in a fixed order and the encoder's pull-back has no
    # atomics: models/hash_encoder.py _CornerGather).
    step_2, st_2 = make_ngp_train_step(g, w, ncfg, ncfg_train, p0, backward="mega")
    losses_2 = []
    for _ in range(steps):
        st_2, loss_2 = step_2(st_2)
        losses_2.append(loss_2)
    same_loss = all(torch.equal(a, b) for a, b in zip(losses_m, losses_2))
    same_params = all(torch.equal(a, b) for a, b in zip(tree.leaves(st_m.params), tree.leaves(st_2.params)))
    print(f"phase 4 ngp rerun of the {steps} steps from the same seed: losses bitwise equal {same_loss}, params "
          f"bitwise equal {same_params}")
    check(same_loss and same_params, "two runs of the NGP training steps give the same bits")
    del st_2, step_2
    for i, (snap, lm) in enumerate(zip(snapshots, losses_m), start=1):
        _, (gk, gtk) = k5.ngp_loss_and_grad(g, w, ncfg, snap, t)
        lr_, (gr, _) = k5.ngp_loss_and_grad_ref(g, w, ncfg, snap, t)
        lp, (gpl, gtp) = k5.ngp_loss_and_grad_plain(g, w, ncfg, snap, t)
        d_loss, d_grad = rel(lm, lr_), rel_l2_err(host(cat(tree.leaves(gk))), host(cat(tree.leaves(gr))))
        w_loss = rel(lm, lp)
        w_grad = rel_l2_err(host(cat(tree.leaves(gk))), host(cat(tree.leaves(gpl))))
        print(f"phase 4 ngp step {i}: loss K5 {float(lm):.9g} referee {float(lr_):.9g} rel {d_loss:.3e} (<= 1e-5); "
              f"gradient rel {d_grad:.3e} (<= 1e-4); witness f32 autograd: loss {float(lp):.9g} rel {w_loss:.3e} "
              f"(<= 1e-4; vs the referee {rel(lp, lr_):.3e}), gradient rel {w_grad:.3e} (<= 1e-4)")
        check(np.isfinite(float(lm)) and d_loss <= 1e-5, f"NGP training step {i} loss")
        check(d_grad <= 1e-4, f"NGP training step {i} gradient")
        check(w_loss <= 1e-4 and w_grad <= 1e-4, f"NGP training step {i} against float32 autograd")
        del gr
    del snapshots

    def plain_ngp_step(params0):
        return make_generic_train_step(g, w, lambda p, tt: ngp.generate_fields(g, ncfg, p, tt, g.dt),
                                       ncfg_train, params0, physics_loss="staged")

    step_p, st_p = plain_ngp_step(p0)
    t0 = time.perf_counter()
    losses_p = []
    for _ in range(steps):
        st_p, loss_p_ = step_p(st_p)
        losses_p.append(float(loss_p_))
    torch.cuda.synchronize()
    sec_p = time.perf_counter() - t0
    traj = ", ".join(f"{float(a):.7g}/{b:.7g}" for a, b in zip(losses_m, losses_p))
    print(f"phase 4 ngp trajectories K5/plain: {traj}; wall {sec_m:.3f} s (K5) vs {sec_p:.3f} s (plain), "
          f"{steps} steps incl. first-call set-up")
    check(rel(losses_m[0], losses_p[0]) <= 1e-5, "NGP trajectories start from the same loss")
    del st_m, st_p
    # make_generic_train_step with the fused physics loss: K1's forward
    # partials on the NGP's packed fields, staged backward.
    step_f, st_f = make_generic_train_step(
        g, w, lambda p, tt: ngp.generate_fields(g, ncfg, p, tt, g.dt), ncfg_train, p0, physics_loss="fused",
        generate_packed_fn=lambda p, tt: ngp.generate_fields_packed(g, ncfg, p, tt, g.dt))
    _build.reset_launches()
    st_f, loss_f = step_f(st_f)
    torch.cuda.synchronize()
    generic_launches = dict(_build.LAUNCHES)
    d = rel(loss_f, losses_m[0])
    print(f"phase 4 generic fused step: launches {generic_launches}; loss {float(loss_f):.9g} "
          f"vs K5 step 1 rel {d:.3e} (<= 1e-5)")
    check(generic_launches["residuals"] == 1, "the fused physics loss launches K1 once")
    check(d <= 1e-5, "generic fused step loss")
    del st_f
    torch.cuda.empty_cache()

    # The fit -> serve round trip through the CLI, as a user runs it: the
    # flagship target (make_target at t = 0.25 on 128x96x96) written with
    # utils/export; `fit` for 5 adam steps of each family at the JAX fit
    # flagship's settings (scripts/fit_bench.py:108-130: --family ngp, whose
    # defaults build NGPFieldConfig(), lr 5e-3; --family mlp --hidden 128,
    # lr 3e-3), with --engine mega (K7 / K6 once per step, nothing else
    # launched) and with --engine xla (autograd). Both engines start from
    # the same seeded params: the first loss agrees at the forward's 1e-5,
    # the fifth at 1e-4 and the fitted params at 1e-3 (relative L2; five
    # adam steps from two float32 gradient paths). Then `serve` on the
    # grid (its fields equal grid_infer_any of the loaded params, MLP_INFER_REL)
    # and at 2^17 random points (evaluate_points of the loaded params),
    # `export` of the served snapshot, and one --phys-weight 0.1 step per
    # family (K6 + K4, K7 + K5).
    def run_cli(argv):
        """cli.main(argv) in this process; its JSON line, as a shell reads it."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"cli {argv[0]} exited {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    def flat(tr):
        return cat([x.detach() for x in tree.leaves(tr)])

    fit_launches = {}
    cli_losses = {}
    with tempfile.TemporaryDirectory() as tmp:
        sigma_t, u_t = make_target(g)
        snap = export.save_fields_npz(os.path.join(tmp, "target.npz"), g,
                                      {"sigma": host(sigma_t), "u": host(u_t)}, t=t)
        del sigma_t, u_t
        fit_args = {"ngp": ["--family", "ngp", "--lr", "5e-3"], "mlp": ["--family", "mlp", "--hidden", "128",
                                                                         "--lr", "3e-3"]}
        kernel_of = {"ngp": "fit_ngp", "mlp": "fit"}
        for family in ("ngp", "mlp"):
            outs, params_of = {}, {}
            for engine in ("mega", "xla"):
                ckpt = os.path.join(tmp, f"{family}_{engine}.npz")
                _build.reset_launches()
                t0 = time.perf_counter()
                outs[engine] = run_cli(["fit", "--target", snap, *fit_args[family], "--steps", str(steps),
                                        "--engine", engine, "--out", ckpt])
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                launched = dict(_build.LAUNCHES)
                _, mcfg_l, params_of[engine] = modelio.load_model(ckpt)
                print(f"phase 4 cli fit {family} --engine {engine}: {steps} steps, launches "
                      f"{ {k: v for k, v in launched.items() if v} }, loss {outs[engine]['loss_first']:.9g} -> "
                      f"{outs[engine]['loss_last']:.9g}, PSNR sigma {outs[engine]['snapshots'][0]['psnr_sigma_db']:.3f} "
                      f"dB u {outs[engine]['snapshots'][0]['psnr_u_db']:.3f} dB, compression "
                      f"{outs[engine]['compression_ratio']:.2f}x, {sec:.2f} s incl. set-up and report")
                if engine == "mega":
                    fit_launches[kernel_of[family]] = launched[kernel_of[family]]
                    encodes = steps if family == "ngp" else 0
                    check(launched[kernel_of[family]] == steps and launched["hash_encode"] == encodes
                          and launched["hash_encode pullback"] == encodes
                          and sum(launched.values()) == steps + 2 * encodes,
                          f"cli fit {family} mega launches {kernel_of[family]} (and the encoder's pair) once per "
                          f"step and nothing else")
                else:
                    check(sum(launched.values()) == 0, f"cli fit {family} xla launches no kernel")
            if family == "ngp":
                check(mcfg_l == ngp.NGPFieldConfig(), "cli fit --family ngp builds NGPFieldConfig()")
            d_first = rel(outs["mega"]["loss_first"], outs["xla"]["loss_first"])
            d_last = rel(outs["mega"]["loss_last"], outs["xla"]["loss_last"])
            d_params = rel_l2_err(host(flat(params_of["mega"])), host(flat(params_of["xla"])))
            cli_losses[family] = (outs["mega"]["loss_first"], outs["mega"]["loss_last"])
            print(f"phase 4 cli fit {family} mega vs xla: first loss rel {d_first:.3e} (<= 1e-5), fifth "
                  f"{d_last:.3e} (<= 1e-4), fitted params rel {d_params:.3e} (<= 1e-3)")
            check(outs["mega"]["loss_last"] < outs["mega"]["loss_first"], f"cli fit {family} loss drops")
            check(d_first <= 1e-5 and d_last <= 1e-4 and d_params <= 1e-3, f"cli fit {family} mega vs xla")

            ckpt = os.path.join(tmp, f"{family}_mega.npz")
            gl, mcfg_l, params_l = modelio.load_model(ckpt)
            check(gl == g, "the checkpoint carries the target's grid")
            served = run_cli(["serve", "--ckpt", ckpt, "--out", os.path.join(tmp, f"{family}_served.npz")])
            fields_s, meta = export.load_fields_npz(served["out"])
            with torch.no_grad():
                ref = host(sample.grid_infer_any(gl, mcfg_l, params_l, t))
            d_serve = max(rel_l2_err(fields_s["sigma"], ref[..., 0]),
                          rel_l2_err(fields_s["u"], np.moveaxis(ref[..., 1:4], -1, 0)))
            print(f"phase 4 cli serve {family}: grid {served['grid']} t {meta['t']}, fields vs grid_infer_any "
                  f"rel {d_serve:.3e} (<= {tol.MLP_INFER_REL:.0e})")
            check(d_serve <= tol.MLP_INFER_REL and np.isfinite(fields_s["u"]).all(), f"cli serve {family}")
            pts = np.random.default_rng(1).uniform(0, 1, (1 << 17, 3)).astype(np.float32)
            np.save(os.path.join(tmp, "pts.npy"), pts)
            pout = run_cli(["serve", "--ckpt", ckpt, "--points", os.path.join(tmp, "pts.npy"),
                            "--out", os.path.join(tmp, "vals.npy")])
            vals = np.load(os.path.join(tmp, "vals.npy"))
            with torch.no_grad():
                vref = host(sample.evaluate_points_batched(mcfg_l, params_l, torch.tensor(pts, device=dev), t))
            d_pts = rel_l2_err(vals, vref)
            print(f"phase 4 cli serve {family} --points: {pout['points']} points -> {vals.shape}, vs "
                  f"evaluate_points_batched rel {d_pts:.3e} (<= {tol.MLP_INFER_REL:.0e})")
            check(vals.shape == (1 << 17, 4) and np.isfinite(vals).all() and d_pts <= tol.MLP_INFER_REL,
                  f"cli serve --points {family}")
            eout = run_cli(["export", "--input", served["out"], "--out", os.path.join(tmp, f"{family}.vtk")])
            with open(eout["out"], "rb") as f:
                check(f.read(26).startswith(b"# vtk DataFile Version 3.0"), "cli export writes VTK")
            del params_l, params_of

            _build.reset_launches()
            pw = run_cli(["fit", "--target", snap, *fit_args[family], "--steps", "1", "--engine", "mega",
                          "--phys-weight", "0.1", "--out", os.path.join(tmp, f"{family}_pinn.npz")])
            torch.cuda.synchronize()
            launched = {k: v for k, v in _build.LAUNCHES.items() if v}
            phys_kernel = {"ngp": "mega_ngp", "mlp": "mega_bwd"}[family]
            print(f"phase 4 cli fit {family} --phys-weight 0.1, 1 step: launches {launched}, loss "
                  f"{pw['loss_first']:.9g}")
            encodes = {"hash_encode": 2, "hash_encode pullback": 2} if family == "ngp" else {}
            check(launched == {kernel_of[family]: 1, phys_kernel: 1, **encodes}, f"the composite step launches "
                  f"{kernel_of[family]} and {phys_kernel} once each (and the encoder's pair before each)")
            check(np.isfinite(pw["loss_first"]) and pw["loss_first"] > outs["mega"]["loss_first"],
                  "the composite loss adds the physics term")
        # The transport and Euler paths (K8, K8c): frozen-u rollouts, a
        # model-driven rollout from the fitted MLP, and `simulate`.
        transport_launches = transport_slice(check, run_cli, dev, g, tmp, os.path.join(tmp, "mlp_mega.npz"))
        torch.cuda.empty_cache()
        # The NGP path's reduced tiers, K1's bf16 I/O and the NGP step's
        # engine outside K5's gate.
        tier_launches = ngp_tier_slice(check, dev, g, t, steps, make_target, run_cli, tmp)
    torch.cuda.empty_cache()
    # The sharded entry points over the world-size-1 NCCL group.
    shard_launches = shard_slice(check, dev, g, t, make_target)
    torch.cuda.empty_cache()
    # The sharded transport and Euler paths: K8's slab form only.
    slab_launches = sharded_transport_slice(check, dev, g)
    torch.cuda.empty_cache()
    # fit_resilient over the K4 and K5 training steps, a crash injected.
    resilient_slice(check, dev, g, w, cfg, ngp_flagship, t)
    torch.cuda.empty_cache()

    # ---- 5. times ---------------------------------------------------------
    fs = kmlp.generate_fields_fused(g, cfg, params, t)
    packed = kres.pack_fields(fs)
    times, splits = {}, {}

    def short(kernel_name):
        m = re.search(r"k_\w+(<\d+>)?", kernel_name)
        return m.group(0) if m else kernel_name.split("(")[0][-40:]

    def flag_drops(name, kt, calls=10):
        """A flag where the profiler kept fewer records of a kernel than
        its launches a call times the calls (utils/timing.dropped)."""
        for k in dropped(kt, calls):
            print(f"phase 5 device {name}: DROPPED RECORDS {short(k)}: {kt[k].count} of "
                  f"{kt[k].per_call * calls} (the time a launch is over the records kept)")

    def both(name, kernel_fn, plain_fn, note):
        ms, plain_ms = cuda_time_ms(kernel_fn), cuda_time_ms(plain_fn)
        times[name] = (ms, plain_ms)
        print(f"phase 5 times {name:22s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms {note}")
        kt = device_time_ms(kernel_fn)
        per_kernel = {k: v.call_ms for k, v in kt.items()}
        splits[name] = per_kernel
        if per_kernel:
            dev_ms = sum(per_kernel.values())
            split = ", ".join(f"{short(k)} {v:.4f}" for k, v in sorted(per_kernel.items()))
            print(f"phase 5 device {name:21s}: {dev_ms:.4f} ms on the device per call "
                  f"({100 * dev_ms / ms:.0f}% of the event time): {split}")
            flag_drops(name, kt)
        else:
            print(f"phase 5 device {name:21s}: not measured (the profiler saw no device time)")
        return ms

    ms = both("residuals packed R", lambda: kres.residuals_fused_packed(g, packed),
              lambda: kres.residuals_plain(g, fs), "(128x96x96)")
    print(f"phase 5 times residual throughput: {g.num_cells / (ms * 1e-3) / 1e9:.3f} G cell-iters/s "
          f"(kernel), {64 * g.num_cells / (ms * 1e-3) / 1e9:.1f} GB/s compulsory")
    both("residuals loss", lambda: kres.loss_forward_fused_packed(g, w, packed),
         lambda: kres.loss_partials_plain(g, w, fs), "(partials epilogue)")
    both("residuals scaled g", lambda: kres.loss_backward_fused_packed(g, w, packed),
         lambda: kres.loss_backward_plain(g, w, fs), "(scaled epilogue)")
    packed_b = packed.to(torch.bfloat16)
    both("residuals bf16", lambda: kres.residuals_fused_packed_bf16(g, packed_b),
         lambda: kres.residuals_low_out_plain(g, packed_b), "(bf16 in and out, 32 B a cell)")
    both("residuals mixed_out", lambda: kres.residuals_fused_packed_mixed_out(g, packed),
         lambda: kres.residuals_low_out_plain(g, packed), "(float32 in, bf16 out, 56 B a cell)")
    both("mlp 3-slice packed", lambda: kmlp.generate_fields_fused_packed(g, cfg, params, t),
         lambda: kmlp.mlp_tables_plain(*kmlp.fold_tables(g, cfg, params, ts)), "(H=128)")
    both("mlp 1-slice grid_infer", lambda: kmlp.grid_infer_fused(g, cfg, params, t),
         lambda: kmlp.mlp_tables_plain(*kmlp.fold_tables(g, cfg, params, ts[1:2])), "(H=128, S = 1)")
    tabs = kmlp.fold_tables(g, cfg, params, ts)
    both("mega", lambda: kmega.mega_loss_pipeline(g, w, cfg, params, t),
         lambda: ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs)), "(H=128)")
    both("slice fused pipeline", lambda: kmlp.fused_loss_pipeline(g, w, cfg, params, t),
         lambda: ops.loss_forward(g, w, fields_mod.generate_fields(g, cfg, params, t, g.dt)),
         "(K2 -> K1 vs staged plain)")
    both("mega_bwd", lambda: kbwd.table_loss_and_grad(g, w, *tabs),
         lambda: kbwd.table_loss_and_grad_plain(g, w, *tabs), "(H=128, tables -> loss + table grads)")
    both("mega_loss_and_grad", lambda: kbwd.mega_loss_and_grad(g, w, cfg, params, t),
         lambda: kbwd.mega_loss_and_grad_plain(g, w, cfg, params, t), "(incl. the fold pull-back)")
    steps_fn = {}
    for fused in (True, False):
        scfg = TrainConfig(learning_rate=1e-3, seed=777, t=t, use_fused=fused)
        sstate = state_from_params(scfg, params)
        sstep = make_train_step(g, w, cfg, scfg)
        steps_fn[fused] = lambda sstep=sstep, sstate=sstate: sstep(sstate)
    both("train step", steps_fn[True], steps_fn[False], "(adam; K4 vs plain autograd)")
    # The bf16 tier: each kernel beside its plain bf16 version (its f32
    # kernel's rows are above), and one bf16 training step through K4 bf16
    # against the same step through the plain bf16 version.
    for tier in ("bf16", "bf16x3"):
        both(f"mlp {tier} 3-slice packed", lambda tier=tier: kmlp.generate_fields_fused_packed(g, cfg, params, t, tier),
             lambda tier=tier: kmlp.mlp_tables_plain(*tabs, tier), "(H=128)")
        both(f"mlp {tier} grid_infer", lambda tier=tier: kmlp.grid_infer_fused(g, cfg, params, t, tier),
             lambda tier=tier: kmlp.mlp_tables_plain(*kmlp.fold_tables(g, cfg, params, ts[1:2]), tier),
             "(H=128, S = 1)")
    both("mega bf16", lambda: kmega.mega_loss_pipeline(g, w, cfg, params, t, "bf16"),
         lambda: ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs, "bf16")), "(H=128)")
    both("mega_bwd bf16", lambda: kbwd.table_loss_and_grad(g, w, *tabs, "bf16"),
         lambda: kbwd.table_loss_and_grad_plain(g, w, *tabs, "bf16"), "(H=128, tables -> loss + table grads)")
    scfg_b = TrainConfig(learning_rate=1e-3, seed=777, t=t, use_fused=True, precision="bf16")
    sstep_b, sstate_b = make_train_step(g, w, cfg, scfg_b), state_from_params(scfg_b, params)
    sstate_bp, sched_b = state_from_params(scfg_b, params), make_schedule(scfg_b)

    def plain_bf16_step():
        _, (gp_, _) = kbwd.mega_loss_and_grad_plain(g, w, cfg, sstate_bp.params, t, "bf16")
        return _apply_grads(scfg_b, sched_b, sstate_bp, gp_)

    both("train step bf16", lambda: sstep_b(sstate_b), plain_bf16_step, "(adam; K4 bf16 vs plain bf16)")

    # K5 at the NGP flagship: the kernel from the encoding, as the main path
    # calls it, against its plain version; the whole step with the encoder;
    # one training step; the encoder's forward and pull-back alone.
    ngp_args = head_inputs(g, ncfg, p0)
    both("mega_ngp", lambda: k5.head_loss_and_grad(g, w, *ngp_args),
         lambda: k5.head_loss_and_grad_plain(g, w, *ngp_args), "(NGPFieldConfig(): enc -> loss + grads + dEnc)")
    both("ngp_loss_and_grad", lambda: k5.ngp_loss_and_grad(g, w, ncfg, p0, t),
         lambda: k5.ngp_loss_and_grad_plain(g, w, ncfg, p0, t), "(incl. the encoder and its pull-back)")
    ngp_steps = {}
    for arm, (sstep, sstate) in (("K5", make_ngp_train_step(g, w, ncfg, ncfg_train, p0, backward="mega")),
                                 ("plain", plain_ngp_step(p0))):
        ngp_steps[arm] = lambda sstep=sstep, sstate=sstate: sstep(sstate)
    both("ngp train step", ngp_steps["K5"], ngp_steps["plain"], "(adam; K5 vs plain autograd)")
    # K5's reduced tiers from their encodings (bf16: the fast encode) beside
    # their plain versions, and one training step of each through K5's tier
    # against the same step through the plain tier head.
    for tier in ("bf16", "f32_fastbwd"):
        enc_t = encoders.encode_grid_zcf(ncfg.encoding, p0["tables"], g, fast=tier == "bf16").contiguous()
        args_t = (enc_t, *ngp_args[1:])
        both(f"mega_ngp {tier}", lambda args_t=args_t, tier=tier: k5.head_loss_and_grad(g, w, *args_t, tier),
             lambda args_t=args_t, tier=tier: k5.head_loss_and_grad_plain(g, w, *args_t, tier),
             "(NGPFieldConfig(): enc -> loss + grads + dEnc)")
        tstep, tstate = make_ngp_train_step(g, w, ncfg, ncfg_train, p0, tier, backward="mega")
        pstate, psched = state_from_params(ncfg_train, p0), make_schedule(ncfg_train)

        def plain_tier_step(tier=tier, pstate=pstate, psched=psched):
            _, (gp_, _) = k5._loss_and_grad(g, w, ncfg, pstate.params, t, tier, k5.head_loss_and_grad_plain)
            return _apply_grads(ncfg_train, psched, pstate, gp_)

        both(f"ngp train step {tier}", lambda tstep=tstep, tstate=tstate: tstep(tstate), plain_tier_step,
             f"(adam; K5 {tier} vs the plain {tier} head)")
        del enc_t, args_t, tstate, pstate
    # The bf16 kernels' registers and spills; the flagship's instantiations
    # (K4 bf16's adjoint and its fields pass with the AB ring; K5 bf16 and
    # K7 bf16 at LF = 16, H = 64: <1, 1>; K6 bf16 at H = 128: 24-row chunks;
    # K3 bf16: <true, 3>; K2 bf16 at S = 3 and 1 and bf16x3 at S = 1 with
    # the ring) spill nothing. K2 bf16x3 at S = 3 (<3, 1, 1>) is printed and
    # not held: it spilled before the forward's redesign too (36 / 60 B).
    spill_checks = (("K4", "k_bwd_adjoint", "k_bwd_adjoint_bf16"), ("K5", "k_ngp_fields", "k_ngp_fields_bf16<1>"),
                    ("K5", "k_ngp_adjoint", "k_ngp_adjoint_bf16<1, 1>"), ("K7", "k_ngp_fit", "k_ngp_fit_bf16<1, 1>"),
                    ("K6", "k_fit", f"k_fit_bf16<{kfit.fit_zrows_bf16(128)}>"), ("K3", "k_mega", "k_mega<1, 3>"),
                    *(("K2", "k_mlp_fields_bf16", f"k_mlp_fields_bf16<{n_}, 1>") for n_ in ("3, 0", "1, 0", "1, 1")),
                    ("K4", "k_bwd_fields", "k_bwd_fields<1, 1>"))
    for pattern in dict.fromkeys(p_ for _, p_, _ in spill_checks):
        names_ = [(k_, n_) for k_, p_, n_ in spill_checks if p_ == pattern]
        for line in sass_count.build_log_lines((pattern,)):
            print(f"phase 5 ptxas {names_[0][0]} {line}")
            for _, flagship_name in names_:
                if line.startswith(flagship_name + ":"):
                    check(" 0 / 0 bytes spill" in line, f"{flagship_name} (the flagship's instantiation) spills nothing")
    del ngp_args
    # The hash grid encoder (csrc/hash_encode.cu) beside its plain ops: the
    # forward, and the pull-back alone (autograd.grad of a kept graph), at
    # NGPFieldConfig() and at ngp_hash_l16 (the NGP cells') on the flagship,
    # and ngp_hash_l16 at 256^3. The least time of each direction is the
    # encoding's bytes and the lattices' at 3.35 TB/s; then each kernel's
    # registers and spills (none allowed).
    torch.cuda.empty_cache()
    for g_enc, enc_cfg, tag in ((g, ncfg.encoding, "NGPFieldConfig() 128x96x96"),
                                (g, ngp_l16, "ngp_hash_l16 128x96x96"),
                                (spec(256, 256, 256), ngp_l16, "ngp_hash_l16 256^3")):
        enc_tables = encoders.init_params(enc_cfg, seed=777, device=dev)
        enc_leaves = [x.requires_grad_() for x in tree.leaves(enc_tables)]
        enc_k = encoders.encode_grid_zcf(enc_cfg, enc_tables, g_enc)
        enc_p = hash_enc.encode_grid_zcf_plain(enc_cfg, enc_tables, g_enc)
        denc_ct = torch.ones_like(enc_k)
        lattice = sum(2 * (int(r) + 1) ** 3 for r in enc_cfg.level_resolutions())
        least = 4 * (enc_k.numel() + lattice) / 3.35e12 * 1e3
        both(f"hash encode {tag}", lambda c=enc_cfg, tb=enc_tables, ge=g_enc: encoders.encode_grid_zcf(c, tb, ge),
             lambda c=enc_cfg, tb=enc_tables, ge=g_enc: hash_enc.encode_grid_zcf_plain(c, tb, ge),
             f"(least {least:.4f} ms, bytes)")
        both(f"hash encode pullback {tag}",
             lambda e=enc_k, lv=enc_leaves, ct=denc_ct: torch.autograd.grad(e, lv, ct, retain_graph=True),
             lambda e=enc_p, lv=enc_leaves, ct=denc_ct: torch.autograd.grad(e, lv, ct, retain_graph=True),
             f"(least {least:.4f} ms, bytes)")
        del enc_leaves, enc_tables, enc_k, enc_p, denc_ct
        torch.cuda.empty_cache()
    for line in sass_count.build_log_lines(("k_hash_",)):
        print(f"phase 5 ptxas hash_encode {line}")
        check(" 0 / 0 bytes spill" in line, f"{line.split(':')[0]} spills nothing")

    # K6 and K7 at the fit flagship, as the main path calls them (the tables
    # or the encoding and the packed target in, the data loss and the
    # gradients out), against their plain versions; then one fit step (adam)
    # of each family through each engine: mega (K6 / K7) against xla.
    sigma_t, u_t = make_target(g)
    fit_tgt = ff.FitTarget(sigma_t, u_t, t)
    fit_target = kfit.pack_target(g, sigma_t, u_t)
    fit_params = mlp.init_params(cfg.dims, seed=0, device=dev)
    fit_tabs = kmlp.fold_tables(g, cfg, fit_params, torch.full((1,), t, device=dev))
    both("fit", lambda: kfit.fit_table_loss_and_grad(g, w, *fit_tabs, fit_target),
         lambda: kfit.fit_table_loss_and_grad_plain(g, w, *fit_tabs, fit_target),
         "(H=128: tables + target -> data loss + table grads)")
    both("fit bf16", lambda: kfit.fit_table_loss_and_grad(g, w, *fit_tabs, fit_target, "bf16"),
         lambda: kfit.fit_table_loss_and_grad_plain(g, w, *fit_tabs, fit_target, "bf16"),
         "(H=128: tables + target -> data loss + table grads)")
    fcfg_b = TrainConfig(learning_rate=3e-3, precision="bf16")
    fstep_b, fstate_b = ff.make_fit_step(g, cfg, [fit_tgt], fcfg_b, engine="mega", device=dev)
    fplain_b, fsched_b = state_from_params(fcfg_b, fit_params), make_schedule(fcfg_b)

    def plain_fit_bf16_step():
        _, (gp_, _) = kfit._loss_and_grad(g, cfg, fplain_b.params, fit_target, t, PhysWeights(), "bf16",
                                          kfit.fit_table_loss_and_grad_plain)
        return _apply_grads(fcfg_b, fsched_b, fplain_b, gp_)

    both("fit step mlp bf16", lambda: fstep_b(fstate_b), plain_fit_bf16_step, "(adam; K6 bf16 vs plain bf16)")
    del fstate_b, fplain_b
    fit_p0 = ngp.init_ngp_params(ncfg, seed=0, device=dev)
    fit_enc = encoders.encode_grid_zcf(ncfg.encoding, fit_p0["tables"], g).contiguous()
    fit_head = (fit_enc, *(fit_p0[k] for k in ("W1", "b1", "W2", "b2")), torch.full((), t, device=dev), fit_target)
    both("fit_ngp", lambda: kfit.ngp_fit_head_loss_and_grad(g, w, *fit_head),
         lambda: kfit.ngp_fit_head_loss_and_grad_plain(g, w, *fit_head),
         "(NGPFieldConfig(): enc + target -> data loss + head grads + dEnc)")
    fit_enc_b = encoders.encode_grid_zcf(ncfg.encoding, fit_p0["tables"], g, fast=True).contiguous()
    fit_head_b = (fit_enc_b, *fit_head[1:])
    both("fit_ngp bf16", lambda: kfit.ngp_fit_head_loss_and_grad(g, w, *fit_head_b, "bf16"),
         lambda: kfit.ngp_fit_head_loss_and_grad_plain(g, w, *fit_head_b, "bf16"),
         "(NGPFieldConfig(), the fast encode: enc + target -> data loss + head grads + dEnc)")
    fcfg_nb = TrainConfig(learning_rate=5e-3, precision="bf16")
    fstep_nb, fstate_nb = ff.make_fit_step(g, ncfg, [fit_tgt], fcfg_nb, params0=fit_p0, engine="mega")
    fplain_nb, fsched_nb = state_from_params(fcfg_nb, fit_p0), make_schedule(fcfg_nb)

    def plain_fit_ngp_bf16_step():
        _, (gp_, _) = kfit._ngp_loss_and_grad(g, ncfg, fplain_nb.params, fit_target, t, PhysWeights(), "bf16",
                                              kfit.ngp_fit_head_loss_and_grad_plain)
        return _apply_grads(fcfg_nb, fsched_nb, fplain_nb, gp_)

    both("fit step ngp bf16", lambda: fstep_nb(fstate_nb), plain_fit_ngp_bf16_step,
         "(adam; K7 bf16 vs the plain bf16 head)")
    del fit_enc, fit_head, fit_enc_b, fit_head_b, fstate_nb, fplain_nb
    for family, mcfg_f, lr_f in (("mlp", cfg, 3e-3), ("ngp", ncfg, 5e-3)):
        fit_steps = {}
        for engine in ("mega", "xla"):
            sstep, sstate = ff.make_fit_step(g, mcfg_f, [fit_tgt], TrainConfig(learning_rate=lr_f), engine=engine,
                                          device=dev)
            fit_steps[engine] = lambda sstep=sstep, sstate=sstate: sstep(sstate)
        both(f"fit step {family}", fit_steps["mega"], fit_steps["xla"],
             f"(adam; {'K6' if family == 'mlp' else 'K7'} vs autograd of the data loss)")
        del fit_steps
    del sigma_t, u_t, fit_tgt, fit_target, fit_tabs, fit_p0
    torch.cuda.empty_cache()

    # K8 (C = 1 and the Euler self-advection's C = 3), K8c and P1 at their
    # main-path shapes, and one Euler step (FFT projection) per advection
    # scheme, through K8 and through the plain versions.
    from phys_autodiff_tpu_torch.apps import euler
    from phys_autodiff_tpu_torch.kernels import probe as kprobe
    from phys_autodiff_tpu_torch.kernels import transport as ktr

    sig_b, u_b = transport_field(g, dev)
    both("transport", lambda: ktr.transport_step_fused(g, sig_b, u_b, g.dt),
         lambda: ktr.transport_step_plain(g, sig_b, u_b, g.dt), "(C=1, the transport-bench field, CFL 0.8)")
    both("transport C=3", lambda: ktr.transport_step_many_fused(g, u_b, u_b, g.dt),
         lambda: ktr.transport_step_many_plain(g, u_b, u_b, g.dt), "(u advecting itself, as in an Euler step)")
    w8 = ktr.transport_weights(g, u_b, g.dt)
    both("transport_pre", lambda: ktr.transport_step_fused_pre(g, sig_b, w8),
         lambda: ktr.transport_pre_plain(g, sig_b, w8), "(the six weight planes)")
    # K8 against DRAM: 256^3 moves 335.5 MB a call, beyond the 50 MB L2.
    big = dataclasses.replace(g, nx=256, ny=256, nz=256)
    sig_big, u_big = transport_field(big, dev)
    ms_big = both("transport 256^3", lambda: ktr.transport_step_fused(big, sig_big, u_big, big.dt),
                  lambda: ktr.transport_step_plain(big, sig_big, u_big, big.dt), "(C=1, 256x256x256)")
    dev_big = sum(splits["transport 256^3"].values()) or float("nan")
    print(f"phase 5 times transport 256^3 rate : {20 * big.num_cells / (ms_big * 1e-3) / 1e9:.1f} GB/s compulsory "
          f"by events ({20 * big.num_cells / (ms_big * 1e-3) / 3.35e12:.1%} of 3.35 TB/s), "
          f"{20 * big.num_cells / (dev_big * 1e-3) / 1e9:.1f} GB/s on the device "
          f"({20 * big.num_cells / (dev_big * 1e-3) / 3.35e12:.1%})")
    del sig_big, u_big
    x_probe = torch.ones(96, 128, device=dev)
    both("probe", lambda: kprobe.probe(x_probe), lambda: kprobe.probe_plain(x_probe), "([96, 128]: the launch floor)")
    # The wrappers' host cost: event ms less device ms, against P1's (the
    # least any launch costs).
    print("phase 5 host transport: event minus device ms " + ", ".join(
        f"{name} {times[name][0] - sum(splits[name].values()):.4f}" if splits[name] else f"{name} not measured"
        for name in ("transport", "transport C=3", "transport_pre", "probe")))
    # The shard-local builds at the 2- and 4-way splits of 128x96x96
    # (nz_local 48 and 24; the second shard, an interior one) beside their
    # plain versions; the whole grid's rows are above. The JSON rows take
    # the 4-way split's.
    from phys_autodiff_tpu_torch.kernels.mega_bwd import halo_rows

    ngp_args = head_inputs(g, ncfg, p0)
    sigma_x, u_x = make_target(g)
    fit_target = kfit.pack_target(g, sigma_x, u_x)
    fit_tabs = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=0, device=dev), torch.full((1,), t, device=dev))
    fit_p0 = ngp.init_ngp_params(ncfg, seed=0, device=dev)
    fit_head = (encoders.encode_grid_zcf(ncfg.encoding, fit_p0["tables"], g).contiguous(),
                *(fit_p0[k] for k in ("W1", "b1", "W2", "b2")), torch.full((), t, device=dev))
    fit_head_b = (encoders.encode_grid_zcf(ncfg.encoding, fit_p0["tables"], g, fast=True).contiguous(), *fit_head[1:])
    for n in SPLITS:
        nzl = g.nz // n
        z0, rows_own = nzl, slice(nzl, 2 * nzl)
        for tier in ("f32", "bf16"):
            both(f"{_shard_counter('mega_bwd', tier)} {nzl}",
                 lambda tier=tier, nzl=nzl, z0=z0: kbwd.table_loss_and_grad_shard(g, w, *tabs, z0, nzl, tier),
                 lambda tier=tier, nzl=nzl, z0=z0: kbwd.table_loss_and_grad_shard_plain(g, w, *tabs, z0, nzl, tier),
                 f"(H=128, rows [{z0}, {z0 + nzl}) of {g.nz})")
        for tier in ("f32", "bf16", "f32_fastbwd"):
            enc_x = encoders.encode_grid_zcf_rows(ncfg.encoding, p0["tables"], g, halo_rows(g, z0, nzl, dev),
                                                  fast=tier == "bf16").contiguous()
            args_x = (enc_x, *ngp_args[1:])
            both(f"{_shard_counter('mega_ngp', tier)} {nzl}",
                 lambda args_x=args_x, tier=tier, nzl=nzl, z0=z0: k5.head_loss_and_grad_shard(
                     g, w, *args_x, z0, nzl, tier),
                 lambda args_x=args_x, tier=tier, nzl=nzl, z0=z0: k5.head_loss_and_grad_shard_plain(
                     g, w, *args_x, z0, nzl, tier),
                 f"(NGPFieldConfig(), rows [{z0}, {z0 + nzl}) of {g.nz}, the encoding of nz_local + 4 rows)")
        tgt_x = fit_target[rows_own].contiguous()
        for tier in ("f32", "bf16"):
            both(f"{_shard_counter('fit', tier)} {nzl}",
                 lambda tier=tier, nzl=nzl, z0=z0, tgt_x=tgt_x: kfit.fit_table_loss_and_grad_shard(
                     g, w, *fit_tabs, tgt_x, z0, nzl, tier),
                 lambda tier=tier, nzl=nzl, z0=z0, tgt_x=tgt_x: kfit.fit_table_loss_and_grad_shard_plain(
                     g, w, *fit_tabs, tgt_x, z0, nzl, tier),
                 f"(H=128, rows [{z0}, {z0 + nzl}))")
            head_x = (fit_head_b if tier == "bf16" else fit_head)
            args_x = (head_x[0][rows_own].contiguous(), *head_x[1:], tgt_x)
            both(f"{_shard_counter('fit_ngp', tier)} {nzl}",
                 lambda tier=tier, nzl=nzl, z0=z0, args_x=args_x: kfit.ngp_fit_head_loss_and_grad_shard(
                     g, w, *args_x, z0, nzl, tier),
                 lambda tier=tier, nzl=nzl, z0=z0, args_x=args_x: kfit.ngp_fit_head_loss_and_grad_shard_plain(
                     g, w, *args_x, z0, nzl, tier),
                 f"(NGPFieldConfig(), rows [{z0}, {z0 + nzl}))")
        torch.cuda.empty_cache()
    del ngp_args, sigma_x, u_x, fit_target, fit_tabs, fit_p0, fit_head, fit_head_b
    # The sharded fused step's mega arm over the world-size-1 NCCL group
    # against the single-device fused step (the same K4 launch; the
    # difference is the sharded entry point's collectives and gathers).
    from phys_autodiff_tpu_torch.parallel import sharded as sh

    shstep, shinit = sh.make_sharded_fused_train_step(g, w, cfg, world_of_one(dev), 1e-3, backward="mega")
    shstate = shinit(params)
    both("sharded train step", lambda: shstep(shstate, t), steps_fn[True],
         "(1 rank: the shard-local K4 and its collectives vs make_train_step(use_fused=True))")
    del shstate
    # F12: one fused training step past K4's gate (H = 1400: K3 forward,
    # the slab-recompute backward, sz = pick_slab_rows) at 128x96x96.
    from phys_autodiff_tpu_torch.train.slab_grad import pick_slab_rows

    cfg_w = MLPGridConfig(dims=MLPDims(H=1400))
    wcfg = TrainConfig(learning_rate=1e-3, seed=777, t=t, use_fused=True)
    wstep, wstate = make_train_step(g, w, cfg_w, wcfg), state_from_params(
        wcfg, mlp.init_params(cfg_w.dims, seed=777, device=dev))
    f12_ms = cuda_time_ms(lambda: wstep(wstate), warmup=1, iters=3)
    f12_kt = device_time_ms(lambda: wstep(wstate), calls=2)
    flag_drops("F12 fused step H=1400", f12_kt, calls=2)
    f12_dev = call_ms(f12_kt)
    print(f"phase 5 times F12 fused step H=1400 : {f12_ms:.2f} ms a step (events), {f12_dev:.2f} ms on the device "
          f"(128x96x96, slabs of {pick_slab_rows(g, 1400)} rows: K3 forward, the slab-recompute backward)")
    del wstep, wstate
    torch.cuda.empty_cache()
    # P1's function is one library call; no single PyTorch call computes K1-K8.
    library = {"probe": cuda_time_ms(lambda: torch.add(x_probe, 1.0))}
    lib_kt = device_time_ms(lambda: torch.add(x_probe, 1.0))
    flag_drops("probe library", lib_kt)
    lib_dev = call_ms(lib_kt)
    print(f"phase 5 times probe library        : torch.add(x, 1.0) {library['probe']:.4f} ms (events), "
          f"{lib_dev:.4f} ms on the device")
    rng = np.random.default_rng(0)
    st0 = euler.EulerState(torch.tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                           torch.tensor((0.3 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev))
    for scheme, tag in (("semi_lagrangian", "SL"), ("maccormack", "MacCormack")):
        ecfg = euler.EulerConfig(dt=2e-3, buoyancy=0.5, advection=scheme, projection="fft")

        def plain_step(ecfg=ecfg):
            with plain_transport():
                return euler.euler_step(g, st0, ecfg)

        with torch.no_grad():
            both(f"euler step {tag}", lambda ecfg=ecfg: euler.euler_step(g, st0, ecfg), plain_step,
                 "(FFT projection, buoyancy 0.5; plain = K8's plain version)")
    # K8's slab form at the 2- and 4-way splits' shards (nz_local 48 and 24,
    # the second shard, C = 1) beside its plain twin; then one sharded
    # transport step and one sharded Euler step over the world-size-1 NCCL
    # group beside the single-device ones (events and device ms).
    from phys_autodiff_tpu_torch.apps import transport as tr

    for n in SPLITS:
        nzl = g.nz // n
        s_ext, u_ext = slab_of(g, sig_b[None], nzl, nzl), slab_of(g, u_b, nzl, nzl)
        both(f"transport slab {nzl}", lambda s_ext=s_ext, u_ext=u_ext: ktr.transport_step_slab(g, s_ext, u_ext, g.dt),
             lambda s_ext=s_ext, u_ext=u_ext: ktr.transport_step_slab_plain(g, s_ext, u_ext, g.dt),
             f"(C=1, planes [{nzl - 1}, {2 * nzl + 1}) of {g.nz}: the shard and its halo planes)")
    mesh1 = world_of_one(dev)
    sl_step = tr.make_shard_local_step(g, tr.TransportConfig(dt=g.dt), mesh1)
    u_ext1 = slab_of(g, u_b, 0, g.nz)
    ecfg1 = euler.EulerConfig(dt=2e-3, steps=1, buoyancy=0.5, advection="maccormack", projection="fft")
    for name, fn in (("sharded transport step", lambda: sl_step(sig_b, u_b, g.dt, u_ext1)),
                     ("transport step", lambda: tr.transport_step(g, sig_b, u_b, g.dt)),
                     ("sharded euler step", lambda: euler.rollout_sharded(g, st0, ecfg1, mesh1)),
                     ("euler step", lambda: euler.rollout(g, st0, ecfg1))):
        with torch.no_grad():
            ms = cuda_time_ms(fn)
            kt = device_time_ms(fn)
        flag_drops(name, kt)
        times[name] = (ms, call_ms(kt))
        print(f"phase 5 times {name:22s}: {ms:.4f} ms (events), {call_ms(kt):.4f} ms on the device "
              f"({'1 rank, the halo exchanges and K8 slab' if name.startswith('sharded') else 'one device, K8'}; "
              f"{'MacCormack, buoyancy 0.5, FFT projection, the diagnostics' if 'euler' in name else 'C = 1'})")
    del sig_b, u_b, w8, st0, s_ext, u_ext, u_ext1
    torch.cuda.empty_cache()
    # One K4 training step in a profiler trace, and what the trace and the
    # checks cost.
    trace_phase(check, steps_fn[True], lambda: kmega.mega_loss_pipeline(g, w, cfg, params, t), smi)

    # The least time the card could take for each kernel's work at the shapes
    # timed above (H100 SXM datasheet peaks): the
    # larger of the compulsory bytes (each input read once, each output
    # written once, float32) over 3.35 TB/s and the operations over
    # 67 TFLOP/s (FP32, an FMA counted as two). Operation counts per cell:
    # the residual about 66 (stencil.cuh cell_residual), its adjoint about
    # 250 (adjoint.cuh); a coordinate-MLP head slice 10 per hidden unit (add,
    # max, 4 FMA), its backward 46 (K4 phase B). The NGP head (csrc/mega_ngp.cu):
    # forward 2 LF H for the base and 10 H a slice; backward 41 H (W2 . gy for
    # the t slice and t+dt, t-dt's being its negative, 16; the three masks,
    # the three slice sums and dz1_sum 8; dW2 as a1_t dF + (a1_tp1 - a1_tm1)
    # g/2dt, 17); dW1 and dEnc 2 LF H each: 6 LF H + 71 H in all. The fit
    # kernels (csrc/fit.cu, csrc/fit_ngp.cu): K6 29 H + 23 a cell (forward
    # 10 H; W2 . gy 8 H, the mask, dAB and dCD H each, dW2 8 H; e, the
    # squares, gy and db2 23), K7 6 LF H + 28 H + 23 (forward 2 LF H + 10 H;
    # backward 18 H and dW1c, dEnc 2 LF H each; the same 23). K8
    # (csrc/transport.cu, C = 1): sigma and u read, sigma' written, 20 B and
    # about 30 operations a cell (3 sweeps of offset, clip, select, lerp;
    # the self-advection C = 3: u read, u' written, 24 B and 30 a channel;
    # 256^3: the same per cell);
    # K8c: sigma and six weight planes read, 32 B and 18 operations a cell;
    # P1 (csrc/probe.cu): 8 B and 1 operation a cell of the [96, 128] plane.
    peak_bytes, peak_flops = 3.35e12, 67e12
    n_cells, (nz, ny, nx), hm = g.num_cells, g.shape, cfg.dims.H
    lf, hn = ncfg.encoding.out_dim, ncfg.hidden
    res_ops, adj_ops = 66, 250
    tables_mlp = hm * ny * nx + nz * hm * 3 + 5 * hm
    work = {
        "residuals": (4 * 16 * n_cells, res_ops * n_cells),
        "mlp": (4 * (tables_mlp + 12 * n_cells), 30 * hm * n_cells),
        "mega": (4 * (tables_mlp + 2 * nz), (30 * hm + res_ops + 7) * n_cells),
        "mega_bwd": (4 * (2 * tables_mlp + 2), (76 * hm + res_ops + adj_ops) * n_cells),
        "mega_ngp": (4 * (2 * lf * n_cells + 2 * ((lf + 1) * hn + 5 * hn + 4) + 3 + 2),
                     (6 * lf * hn + 71 * hn + res_ops + adj_ops) * n_cells),
        "fit": (4 * (2 * hm * ny * nx + 2 * nz * hm + 8 * hm + 8 + 4 * n_cells + 2), (29 * hm + 23) * n_cells),
        "fit_ngp": (4 * ((2 * lf + 4) * n_cells + 2 * ((lf + 1) * hn + 5 * hn + 4) + 1 + 2),
                    (6 * lf * hn + 28 * hn + 23) * n_cells),
        "transport": (20 * n_cells, 30 * n_cells),
        "transport C=3": (24 * n_cells, 90 * n_cells),
        "transport 256^3": (20 * 256 ** 3, 30 * 256 ** 3),
        "transport_pre": (32 * n_cells, 18 * n_cells),
        "probe": (8 * 96 * 128, 96 * 128),
        # K8's slab form at the 4-way split (C = 1): sigma and u of the
        # nz_local + 2 planes read, nz_local planes written; the operations
        # of the owned cells
        "transport slab": (4 * ((1 + 3) * (nz // 4 + 2) + nz // 4) * ny * nx, 30 * (nz // 4) * ny * nx),
    }
    # The bf16 tier (csrc/mlp_mma.cuh): its compulsory bytes are the f32
    # kernel's; the CUDA cores keep, per (cell, slice, hidden unit), the add,
    # half a convert and half a bf16x2 max (2) in the forward, and in the
    # backward per (cell, hidden unit) the three slices' adds, maxes, masks,
    # dAB and dCD adds and dW2's converts (16.5; K6's one slice 5.5); bf16x3
    # 6 a forward value (the max in float32, the split: 3 more, a convert). The tensor-core FLOP as
    # issued (n = 8 of which 4 outputs are real, k padded): the forward's
    # m16n8k16 256 a (cell, slice) per 16 hidden units (16 H; 48 H for
    # bf16x3's three products), the backward's da1 (m16n8k8, k = 4 padded to
    # 8) 16 H a cell per cotangent kind (K4 two, K6 one) and dW2 (m16n8k16)
    # 16 H a cell per slice, over the H100 SXM datasheet's dense BF16 peak.
    peak_tc = 989e12
    work_tc = {
        "mlp bf16": (work["mlp"][0], 6 * hm * n_cells, 48 * hm * n_cells),
        "mlp bf16x3": (work["mlp"][0], 18 * hm * n_cells, 144 * hm * n_cells),
        # S = 1: one slice's fields and CD rows, a third of the operations
        "mlp bf16 S=1": (4 * (hm * ny * nx + nz * hm + 5 * hm + 4 * n_cells), 2 * hm * n_cells, 16 * hm * n_cells),
        "mlp bf16x3 S=1": (4 * (hm * ny * nx + nz * hm + 5 * hm + 4 * n_cells), 6 * hm * n_cells, 48 * hm * n_cells),
        "mega bf16": (work["mega"][0], (6 * hm + res_ops + 7) * n_cells, 48 * hm * n_cells),
        "mega_bwd bf16": (work["mega_bwd"][0], (22.5 * hm + res_ops + adj_ops) * n_cells, 128 * hm * n_cells),
        "fit bf16": (work["fit"][0], (7.5 * hm + 23) * n_cells, 48 * hm * n_cells),
        # The NGP kernels' bf16 tier: the f32 kernel's bytes (the encoding is
        # read in float32); the products on the tensor cores, as the
        # function needs them (the head's real outputs; K5 bf16 issues every
        # one of them on mma.sync, N padded to 8 and pass 3's base
        # recomputed beside these): K5 base, dW1 and dEnc 2 LF H each,
        # layer 2 8 H a slice, da1 8 H for the t slice and t+dt, dW2 8 H for
        # the t slice and the t -+ dt pair; on the CUDA cores the adds and
        # ReLUs 6 H, the masks and the three slice sums 8 H, dW2's
        # difference H, and the residual and its adjoint. K7: base, dW1,
        # dEnc 2 LF H each, y, da1 and dW2 8 H each; the add, ReLU, mask and
        # db1 4 H, e and the rest 23.
        "mega_ngp bf16": (work["mega_ngp"][0], (15 * hn + res_ops + adj_ops) * n_cells,
                          (6 * lf * hn + 56 * hn) * n_cells),
        # K5 f32_fastbwd is the f32 function with roundings: the f32
        # kernel's bytes, its products (6 LF H + 56 H a cell, the bf16
        # row's) counted at the cheapest f32-class route the card has, three
        # bf16 products each on the tensor cores, and the rest (15 H, the
        # residual and its adjoint) on the CUDA cores.
        "mega_ngp f32_fastbwd": (work["mega_ngp"][0], (15 * hn + res_ops + adj_ops) * n_cells,
                                 3 * (6 * lf * hn + 56 * hn) * n_cells),
        "fit_ngp bf16": (work["fit_ngp"][0], (4 * hn + 23) * n_cells, (6 * lf * hn + 24 * hn) * n_cells),
    }
    work.update({k: v[:2] for k, v in work_tc.items()})
    # K1's bf16-I/O entry points: 12 bf16 reads and 4 bf16 writes a cell
    # (32 B), or 12 float32 reads and 4 bf16 writes (56 B), and the
    # residual's operations.
    work.update({"residuals bf16": (32 * n_cells, res_ops * n_cells),
                 "residuals mixed_out": (56 * n_cells, res_ops * n_cells)})

    # The shard-local builds at the 4-way split (nz_local = nz / 4): K4 and
    # K5 compute the fields and residuals of nz_local + 4 rows (the halo
    # recomputed, work the shard must do) and the backward of their own
    # nz_local rows; their bytes are the tables (or the encoding of the
    # nz_local + 4 rows) read and the gradients (dCD or dEnc of the own
    # rows) written. K6 and K7 run the whole function on their own rows.
    nzs = nz // 4
    own, ext = nzs * ny * nx, (nzs + 4) * ny * nx
    plane_h = hm * ny * nx
    head_words = 2 * ((lf + 1) * hn + 5 * hn + 4)
    work_shard = {
        "mega_bwd shard": (4 * (2 * plane_h + (2 * nzs + 4) * hm * 3 + 10 * hm + 2 * nzs),
                           (30 * hm + res_ops) * ext + (46 * hm + adj_ops) * own),
        "mega_bwd bf16 shard": (4 * (2 * plane_h + (2 * nzs + 4) * hm * 3 + 10 * hm + 2 * nzs),
                                (6 * hm + res_ops) * ext + (16.5 * hm + adj_ops) * own, 48 * hm * ext + 80 * hm * own),
        "mega_ngp shard": (4 * (lf * (ext + own) + head_words + 3 + 2 * nzs),
                           (2 * lf * hn + 30 * hn + res_ops) * ext + (4 * lf * hn + 41 * hn + adj_ops) * own),
        "mega_ngp bf16 shard": (4 * (lf * (ext + own) + head_words + 3 + 2 * nzs),
                                (6 * hn + res_ops) * ext + (9 * hn + adj_ops) * own,
                                (2 * lf * hn + 24 * hn) * ext + (4 * lf * hn + 32 * hn) * own),
        "fit shard": (4 * (2 * plane_h + 2 * nzs * hm + 8 * hm + 8 + 4 * own + 2 * nzs), (29 * hm + 23) * own),
        "fit bf16 shard": (4 * (2 * plane_h + 2 * nzs * hm + 8 * hm + 8 + 4 * own + 2 * nzs), (7.5 * hm + 23) * own,
                           48 * hm * own),
        "fit_ngp shard": (4 * ((2 * lf + 4) * own + head_words + 1 + 2 * nzs), (6 * lf * hn + 28 * hn + 23) * own),
        "fit_ngp bf16 shard": (4 * ((2 * lf + 4) * own + head_words + 1 + 2 * nzs), (4 * hn + 23) * own,
                               (6 * lf * hn + 24 * hn) * own),
    }
    # fastbwd's shard: the f32 shard's bytes, its products as three bf16
    # products each (the bf16 shard's tensor-core count), the rest on the
    # CUDA cores
    work_shard["mega_ngp f32_fastbwd shard"] = (
        work_shard["mega_ngp shard"][0], (6 * hn + res_ops) * ext + (9 * hn + adj_ops) * own,
        3 * ((2 * lf * hn + 24 * hn) * ext + (4 * lf * hn + 32 * hn) * own))
    work_tc.update({k: v for k, v in work_shard.items() if len(v) == 3})
    work.update({k: v[:2] for k, v in work_shard.items()})

    def bound(nbytes, flops, tc_flops=0.0):
        by_bytes, by_ops = nbytes / peak_bytes * 1e3, max(flops / peak_flops, tc_flops / peak_tc) * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    names = ("residuals", "mlp", "mega", "mega_bwd", "mega_ngp", "fit", "fit_ngp", "transport", "transport_pre",
             "probe", "mlp bf16", "mlp bf16x3", "mlp bf16 S=1", "mlp bf16x3 S=1", "mega bf16", "mega_bwd bf16",
             "fit bf16", "mega_ngp bf16",
             "mega_ngp f32_fastbwd", "fit_ngp bf16", "residuals bf16", "residuals mixed_out", *SHARD_ROWS,
             "transport slab")
    sources = {name: f"{name.split()[0]}.cu" for name in names}
    sources["transport_pre"] = sources["transport slab"] = "transport.cu"
    replaces = {
        "residuals": "phys_autodiff_tpu/pallas/residuals.py:392,508,778",
        "mlp": "phys_autodiff_tpu/pallas/mlp.py:199",
        "mega": "phys_autodiff_tpu/pallas/mega.py:316",
        "mega_bwd": "phys_autodiff_tpu/pallas/mega_bwd.py:568",
        "mega_ngp": "phys_autodiff_tpu/pallas/mega_ngp.py:167",
        "fit": "phys_autodiff_tpu/pallas/fit.py:68",
        "fit_ngp": "phys_autodiff_tpu/pallas/fit.py:385",
        "transport": "phys_autodiff_tpu/pallas/transport.py:70,155",
        "transport_pre": "phys_autodiff_tpu/pallas/transport.py:315",
        "probe": "scripts/small_grid_experiments.py:34",
    }
    replaces.update({name: replaces[name.split()[0]] for name in work_tc if not name.endswith("shard")})
    # the shard-local builds: the nz_local build and the sharded entry point
    replaces.update({name: {"mega_bwd": "phys_autodiff_tpu/pallas/mega_bwd.py:568,872",
                            "mega_ngp": "phys_autodiff_tpu/pallas/mega_ngp.py:167,635",
                            "fit": "phys_autodiff_tpu/pallas/fit.py:68,297",
                            "fit_ngp": "phys_autodiff_tpu/pallas/fit.py:385,689"}[name.split()[0]]
                     for name in SHARD_ROWS})
    replaces.update({"mega_ngp f32_fastbwd": replaces["mega_ngp"],
                     "residuals bf16": "phys_autodiff_tpu/pallas/residuals.py:778,1037",
                     "residuals mixed_out": "phys_autodiff_tpu/pallas/residuals.py:778,1076",
                     "transport slab": "phys_autodiff_tpu/pallas/transport.py:70,155"})
    timed = {"residuals": "residuals packed R", "mlp": "mlp 3-slice packed", "mega": "mega",
             "mega_bwd": "mega_bwd", "mega_ngp": "mega_ngp", "fit": "fit", "fit_ngp": "fit_ngp",
             "transport": "transport", "transport_pre": "transport_pre", "probe": "probe",
             "mlp bf16": "mlp bf16 3-slice packed", "mlp bf16x3": "mlp bf16x3 3-slice packed",
             "mlp bf16 S=1": "mlp bf16 grid_infer", "mlp bf16x3 S=1": "mlp bf16x3 grid_infer", "mega bf16": "mega bf16",
             "mega_bwd bf16": "mega_bwd bf16", "fit bf16": "fit bf16", "mega_ngp bf16": "mega_ngp bf16",
             "mega_ngp f32_fastbwd": "mega_ngp f32_fastbwd", "fit_ngp bf16": "fit_ngp bf16",
             "residuals bf16": "residuals bf16", "residuals mixed_out": "residuals mixed_out",
             **{name: f"{name} {g.nz // 4}" for name in SHARD_ROWS}, "transport slab": f"transport slab {g.nz // 4}"}
    # P1 lies on no user path: its main-path count is 0 (phase 3 and 5 launch it)
    launches = {**launches, "mega_bwd": train_launches["mega_bwd"], "mega_ngp": ngp_launches["mega_ngp"],
                **fit_launches, **transport_launches, "probe": 0, **bf16_launches, **tier_launches, **shard_launches,
                **slab_launches}
    rows = []
    for name in names:
        bound_ms, bound_by = bound(*work_tc.get(name, work[name]))
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"phys_autodiff_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[timed[name]][0],
            "plain_ms": times[timed[name]][1],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": library.get(name),
        })
    # The MLP kernels' launches beside their bounds (each launch's device ms
    # per call; a launch made more than once a call, as K5's and K7's
    # k_sum_parts, is summed here), and K3 beside K2 -> K1's partials, the
    # two-kernel composition of the same loss.
    for name in ("mlp", "mega", "mega_bwd", "mega_ngp", "fit", "fit_ngp", *work_tc, "residuals bf16",
                 "residuals mixed_out", "mega_bwd shard", "mega_ngp shard", "fit shard", "fit_ngp shard"):
        bound_ms, bound_by = bound(*work_tc.get(name, work[name]))
        split = splits[timed[name]]
        dev_ms = sum(split.values())
        parts = ", ".join(f"{short(k)} {v:.4f}" for k, v in sorted(split.items()))
        print(f"phase 5 split {name}: {parts}; {dev_ms:.4f} ms on the device against a bound of {bound_ms:.4f} ms "
              f"({bound_by}): {dev_ms / bound_ms:.2f}x" if split else f"phase 5 split {name}: not measured")
    # K8's launches beside their bounds: C = 1, the self-advection's C = 3
    # and K8c at 128x96x96, C = 1 at 256^3.
    parts = []
    work["transport slab 48"] = (4 * ((1 + 3) * (nz // 2 + 2) + nz // 2) * ny * nx, 30 * (nz // 2) * ny * nx)
    for tag, row in (("C=1", "transport"), ("C=3 self", "transport C=3"), ("K8c", "transport_pre"),
                     ("C=1 256^3", "transport 256^3"), ("slab C=1 nz_local 48", "transport slab 48"),
                     ("slab C=1 nz_local 24", "transport slab")):
        bound_ms, bound_by = bound(*work[row])
        split = splits[timed.get(row, row)]
        dev_ms = sum(split.values())
        parts.append(f"{tag} {dev_ms:.4f} ms on the device against {bound_ms:.4f} ({bound_by}): "
                     f"{dev_ms / bound_ms:.2f}x" if split else f"{tag} not measured")
    print("phase 5 split transport: " + "; ".join(parts))
    two, one = splits["slice fused pipeline"], splits["mega"]
    if two and one:
        print(f"phase 5 split K3 vs K2 -> K1: K3 {sum(one.values()):.4f} ms on the device, K2 + K1's partials "
              f"{sum(two.values()):.4f} ms ({', '.join(f'{short(k)} {v:.4f}' for k, v in sorted(two.items()))})")
    import torch.distributed as dist

    if dist.is_initialized():  # the world-size-1 NCCL group of the sharded phases
        dist.destroy_process_group()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
