"""Supervised neural-field fitting: compress grid snapshots into a model
(port of phys_autodiff_tpu/train/fit_field.py).

Fit the parameters of any model family (coordinate MLP, hash NGP, Fourier,
registered encoder families) to one or more grid snapshots with the
reference's weighted-MSE semantics, optionally regularised by the physics
loss (the PINN composite L = L_data + lambda L_phys: data assimilation).
With utils/export and models/sample it closes the round trip: export
snapshots -> fit a neural field -> serve it at grid nodes or arbitrary
points, at a measured compression ratio (`compression_stats`).

Loss semantics mirror the physics loss (reference src/phys_cpu.cpp:140-148):
L = w_sigma mean(dsigma^2) + w_u mean(|du|^2), the u term a mean over N
cells of the channel-summed squared error.

Gradient engines: "mega" computes the data term's loss and every gradient
with one call of K6 (MLP) or K7 (encoded families) per snapshot, and the
physics term of the composite with one call of K4 or K5; "xla" is autograd
of the staged loss (`make_fit_loss`; the JAX package's name for that arm).
The step is train/loop.py's update (the clip, the schedule, torch.optim
over the nested tree), run `cfg.steps` times in a plain loop where the JAX
package runs one lax.scan. `make_sharded_fit_step` fits over a z mesh
(parallel/mesh.py): each rank owns a block of z rows of the targets and of
the model's output, the params are replicated, and the gradients are
all-reduced; its engines are the same two, "mega" on the kernels'
shard-local launches (K6 / K7 on a rank's rows, K4 / K5's shard-local
builds for the composite's physics term), "xla" autograd of a rank's part
of the staged loss.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_fits, mega_loss_and_grad
from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_fits, ngp_loss_and_grad
from phys_autodiff_tpu_torch.models import fields as fields_mod
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.models import sample
from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.train.loop import TrainConfig, _apply_grads, make_schedule, state_from_params
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.utils.timing import annotate


class FitTarget(NamedTuple):
    """One supervision snapshot: the fields the model should reproduce at
    time t, sigma [nz, ny, nx] and channel-first u [3, nz, ny, nx]."""

    sigma: torch.Tensor
    u: torch.Tensor
    t: float


def target_from_arrays(sigma, u, t: float, device="cuda") -> FitTarget:
    """FitTarget from host arrays (e.g. utils.export.load_fields_npz output):
    float32 tensors on `device`."""
    return FitTarget(
        torch.as_tensor(np.asarray(sigma, np.float32), device=device),
        torch.as_tensor(np.asarray(u, np.float32), device=device),
        float(t),
    )


def init_any(model_cfg, seed: int = 0, device="cuda"):
    """Seeded parameters of either model family on `device` (bitwise those
    of the JAX package's init_any for one seed)."""
    if isinstance(model_cfg, MLPGridConfig):
        return mlp.init_params(model_cfg.dims, seed=seed, device=device)
    return ngp_mod.init_ngp_params(model_cfg, seed=seed, device=device)


def data_loss(g: GridSpec, model_cfg, params, target: FitTarget, w: PhysWeights = PhysWeights()) -> torch.Tensor:
    """Weighted field MSE of the model output against one snapshot."""
    out = sample.grid_infer_any(g, model_cfg, params, target.t)
    ds = out[..., 0] - target.sigma
    du = torch.movedim(out[..., 1:4], -1, 0) - target.u
    return float(np.float32(w.w_sigma)) * torch.mean(ds * ds) + float(np.float32(w.w_u)) * torch.mean(
        torch.sum(du * du, dim=0)
    )


def snapshots_from_model(g: GridSpec, model_cfg, params, t) -> FieldSnapshots:
    """The six physics inputs (t-dt, t, t+dt) from any model family: the MLP
    through models.fields.generate_fields (one batched 3-slice evaluation),
    encoded families slice by slice."""
    if isinstance(model_cfg, MLPGridConfig):
        return fields_mod.generate_fields(g, model_cfg, params, t, g.dt)
    slices = []
    for tt in (t - g.dt, t, t + g.dt):
        out = sample.grid_infer_any(g, model_cfg, params, tt)
        slices.append((out[..., 0], torch.movedim(out[..., 1:4], -1, 0)))
    (s_m, u_m), (s_0, u_0), (s_p, u_p) = slices
    return FieldSnapshots(s_m, s_0, s_p, u_m, u_0, u_p)


def make_fit_loss(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
):
    """(params) -> scalar composite loss: the snapshot mean of the data
    loss, plus phys_weight times the snapshot mean of the physics loss
    (phys_weight=0 skips the residual chain)."""
    if not targets:
        raise ValueError("need at least one FitTarget")
    targets = list(targets)
    inv = float(np.float32(1.0 / len(targets)))
    pw = float(np.float32(phys_weight))

    def loss_fn(params):
        total = 0.0
        for tgt in targets:
            total = total + data_loss(g, model_cfg, params, tgt, w_data)
            if phys_weight:
                fs = snapshots_from_model(g, model_cfg, params, tgt.t)
                total = total + pw * ops_loss.total_loss(g, w_phys, fs)
        return total * inv

    return loss_fn


def _eligible(g: GridSpec, model_cfg, phys_weight, precision: str = "f32") -> bool:
    if isinstance(model_cfg, MLPGridConfig):
        h, tier = model_cfg.dims.H, _build.check_precision(precision, "K6")
        return kfit.fit_supported(g) and kfit.fit_fits(h, tier) and (not phys_weight or mega_fits(g, h, tier))
    if not isinstance(model_cfg, ngp_mod.NGPFieldConfig) or model_cfg.out != 4:
        return False
    lf, h = model_cfg.encoding.out_dim, model_cfg.hidden
    k7, k5 = ngp_mod.check_precision(precision, "K7"), ngp_mod.check_precision(precision, "K5")
    return kfit.fit_supported(g) and kfit.ngp_fit_fits(lf, h, k7) and (not phys_weight or ngp_fits(lf, h, k5))


def _resolve_fit_engine(engine: str, g: GridSpec, model_cfg, phys_weight, on_card: bool = False,
                        precision: str = "f32") -> str:
    """"mega" = the one-call kernel engines (K6 / K7 for the data term, K4 /
    K5 for the physics term of the composite); "xla" = autograd of the
    staged loss. "auto" picks mega when the config is eligible and the
    params lie on the card (on the CPU the kernels' plain versions would
    run, which are referees, not a fast path). The xla engine computes in
    float32, so "auto" on the card never takes it for a tier the kernels
    run in other arithmetic ("bf16"): it raises when they cannot take the
    config. The gates are those of the tier: K6 / K4 for the MLP, K7 / K5
    for the encoded field (whose tier is read through K7's table)."""
    if engine == "xla":
        return "xla"
    eligible = _eligible(g, model_cfg, phys_weight, precision)
    if engine not in ("mega", "auto"):
        raise ValueError(f"unknown fit engine {engine!r}")
    if eligible and (engine == "mega" or on_card):
        return "mega"
    if engine == "auto" and not on_card:
        return "xla"
    is_mlp = isinstance(model_cfg, MLPGridConfig)
    # the NGP tier read through K7's table: "f32_high" falls to xla as "f32" does
    tier = _build.check_precision(precision, "K6" if is_mlp else "K7")
    if engine == "auto" and tier == "f32":
        return "xla"
    gates = "kernels/fit.py fit_fits / ngp_fit_fits, plus mega_fits / ngp_fits when phys_weight > 0"
    if is_mlp and kfit.fit_supported(g):
        h = model_cfg.dims.H
        gates = f"K6 ({tier}) H <= {_build.gate_top(lambda x: kfit.fit_fits(x, tier))}"
        if phys_weight:
            gates += f", K4 ({tier}) H <= {_build.gate_top(lambda x: mega_fits(g, x, tier))}"
        gates = f"H={h}; {gates}"
    elif isinstance(model_cfg, ngp_mod.NGPFieldConfig) and model_cfg.out == 4 and model_cfg.encoding.out_dim <= 64:
        lf, h = model_cfg.encoding.out_dim, model_cfg.hidden
        gates = f"K7 ({tier}) H <= {_build.gate_top(lambda x: kfit.ngp_fit_fits(lf, x, tier))}"
        if phys_weight:
            k5 = ngp_mod.check_precision(precision, "K5")
            gates += f", K5 ({k5}) H <= {_build.gate_top(lambda x: ngp_fits(lf, x, k5))}"
        gates = f"LF={lf}, H={h}; {gates}"
    raise ValueError(
        f"engine={engine!r}, precision={precision!r}: needs the MLP or an NGP (out=4) family within the "
        f"kernels' shared-memory gates ({gates}); engine='xla' computes in float32"
    )


def _make_mega_loss_and_grad(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    w_data: PhysWeights,
    phys_weight: float,
    w_phys: PhysWeights,
    precision: str,
):
    """(params) -> (loss, grads) through the kernel engines: the composite
    semantics of make_fit_loss (snapshot mean, + phys_weight times the
    physics loss)."""
    if isinstance(model_cfg, MLPGridConfig):
        data_lag, phys_lag = kfit.fit_loss_and_grad, mega_loss_and_grad
    else:
        data_lag, phys_lag = kfit.ngp_fit_loss_and_grad, ngp_loss_and_grad
    targets = list(targets)
    packed = [kfit.pack_target(g, tgt.sigma, tgt.u) for tgt in targets]
    inv = float(np.float32(1.0 / len(targets)))
    pw = float(np.float32(phys_weight))

    def loss_and_grad(params):
        total, gacc = 0.0, None
        for tgt, pk in zip(targets, packed):
            ld, (gd, _) = data_lag(g, model_cfg, params, pk, tgt.t, w_data, precision=precision)
            total = total + ld
            gacc = gd if gacc is None else tree.unflatten(gacc, [a + b for a, b in zip(tree.leaves(gacc), tree.leaves(gd))])
            if phys_weight:
                lp, (gp, _) = phys_lag(g, w_phys, model_cfg, params, tgt.t, precision)
                total = total + pw * lp
                gacc = tree.unflatten(gacc, [a + pw * b for a, b in zip(tree.leaves(gacc), tree.leaves(gp))])
        return total * inv, tree.map_tree(lambda x: x * inv, gacc)

    return loss_and_grad


def make_fit_step(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    cfg: TrainConfig = TrainConfig(),
    params0: Any | None = None,
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
    engine: str = "auto",
    device="cuda",
):
    """One fitting update as a function: returns (step, state0),
    step(state) -> (state', loss), the loss that of the params before the
    update. The params start from params0 (copied) or init_any(model_cfg,
    cfg.seed) on `device`; the targets are moved to the params' device.

    engine: "auto" | "mega" | "xla" (see _resolve_fit_engine); "mega" on
    CPU params runs the kernels' plain versions. cfg.precision selects the
    kernel tier of the mega engine (kernels/_build.TIERS: "bf16" runs K6 and
    K4 in bf16; the xla engine is float32 autograd whatever the tier, as in
    the JAX package)."""
    params = init_any(model_cfg, seed=cfg.seed, device=device) if params0 is None else params0
    state0 = state_from_params(cfg, params)
    dev = tree.leaves(state0.params)[0].device
    targets = [FitTarget(t.sigma.to(dev), t.u.to(dev), t.t) for t in targets]
    if _resolve_fit_engine(engine, g, model_cfg, phys_weight, dev.type == "cuda", cfg.precision) == "mega":
        loss_and_grad = _make_mega_loss_and_grad(g, model_cfg, targets, w_data, phys_weight, w_phys, cfg.precision)
    else:
        loss_fn = make_fit_loss(g, model_cfg, targets, w_data, phys_weight, w_phys)

        def loss_and_grad(p):
            leaves = tree.leaves(p)
            loss = loss_fn(p)
            gl = torch.autograd.grad(loss, leaves, allow_unused=True)
            gl = [torch.zeros_like(x) if gr is None else gr for gr, x in zip(gl, leaves)]
            return loss.detach(), tree.unflatten(p, gl)

    schedule = make_schedule(cfg)

    def step(state):
        with annotate("pat.step", state.step):
            loss, grads = loss_and_grad(state.params)
            return _apply_grads(cfg, schedule, state, grads), loss

    return step, state0


def fit_field(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    cfg: TrainConfig = TrainConfig(),
    params0: Any | None = None,
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
    engine: str = "auto",
    device="cuda",
):
    """Fit model_cfg's parameters to the target snapshots: cfg.steps
    updates of make_fit_step (cfg's optimizer, schedule and clip,
    train/loop.py) in a plain loop where the JAX package runs one lax.scan.
    Returns (params, losses [cfg.steps]); each loss is that of the params
    before its update. Arguments as make_fit_step's."""
    step, state = make_fit_step(g, model_cfg, targets, cfg, params0, w_data, phys_weight, w_phys, engine, device)
    losses = []
    for _ in range(cfg.steps):
        state, loss = step(state)
        losses.append(loss)
    return tree.map_tree(lambda x: x.detach(), state.params), torch.stack(losses) if losses else torch.zeros(0)


def psnr(pred, ref) -> torch.Tensor:
    """Peak signal-to-noise ratio (dB) with the reference's dynamic range as
    the peak: the fit-quality scalar of neural-field compression."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    ref = torch.as_tensor(ref, dtype=torch.float32).to(pred.device)
    mse = torch.mean((pred - ref) ** 2)
    peak = torch.max(ref) - torch.min(ref)
    return 10.0 * torch.log10(peak * peak / torch.clamp_min(mse, 1e-30))


def fit_report(g: GridSpec, model_cfg, params, targets: Sequence[FitTarget]) -> dict:
    """Per-snapshot PSNR (sigma and u) and the compression stats, as plain
    Python floats: the user-facing summary of a fit."""
    rows = []
    with torch.no_grad():
        for tgt in targets:
            out = sample.grid_infer_any(g, model_cfg, params, tgt.t)
            rows.append({
                "t": float(tgt.t),
                "psnr_sigma_db": float(psnr(out[..., 0], tgt.sigma)),
                "psnr_u_db": float(psnr(torch.movedim(out[..., 1:4], -1, 0), tgt.u)),
            })
    return {"snapshots": rows, **compression_stats(params, g, len(targets))}


def compression_stats(params, g: GridSpec, num_snapshots: int) -> dict:
    """Model bytes against raw snapshot bytes (4 float32 channels a cell a
    snapshot). A ratio above 1 means the neural field is smaller than the
    data it reproduces, and it serves continuous (x, y, z, t) besides."""
    param_bytes = int(sum(x.numel() * x.element_size() for x in tree.leaves(params)))
    raw_bytes = int(num_snapshots) * 4 * g.num_cells * 4
    return {"param_bytes": param_bytes, "raw_bytes": raw_bytes, "compression_ratio": raw_bytes / max(param_bytes, 1)}


# ---------------------------------------------------------------------------
# The sharded fit (JAX train/fit_field.py:298-450)
# ---------------------------------------------------------------------------


def _rows_output(g: GridSpec, model_cfg, params, t, rows: torch.Tensor) -> torch.Tensor:
    """The model's output [R, ny, nx, 4] at time t on the given global z
    rows: the coordinate MLP on those rows' coordinates, or the encoded
    field's head on the rows' encoding (encoders.encode_grid_zcf_rows)."""
    if isinstance(model_cfg, MLPGridConfig):
        from phys_autodiff_tpu_torch.parallel.sharded import row_outputs

        return row_outputs(g, model_cfg, params, np.array([t], np.float32), rows)[0]
    enc = encoders.encode_grid_zcf_rows(model_cfg.encoding, params["tables"], g, rows)
    return ngp_mod._apply_head(params, torch.movedim(enc, 1, -1), t)


def _rows_snapshots(g: GridSpec, model_cfg, params, t, rows: torch.Tensor):
    """(sigma [3, R, ny, nx], u [3, 3, R, ny, nx]) of the slices t-dt, t,
    t+dt on the given rows, for the physics term."""
    if isinstance(model_cfg, MLPGridConfig):
        from phys_autodiff_tpu_torch.parallel.sharded import _row_fields

        return _row_fields(g, model_cfg, params, t, rows)
    ys = [_rows_output(g, model_cfg, params, float(tt), rows) for tt in fields_mod.slice_times(t, g.dt)]
    return torch.stack([y[..., 0] for y in ys]), torch.stack([torch.movedim(y[..., 1:4], -1, 0) for y in ys])


def _sharded_xla_loss_and_grad(g, model_cfg, targets, mesh, w_data, phys_weight, w_phys):
    """(params) -> (loss, grads) of the composite on the mesh: each rank's
    part of the staged loss (its rows' data error; its rows' residuals from
    the fields of its rows and one halo row a side) by autograd, then the
    loss and the gradients all-reduced."""
    z0, nz_local = mesh.rows(g.nz)
    dev = mesh.device
    own = torch.arange(z0, z0 + nz_local, device=dev)
    ext = ops_stencil.z_rows(g, z0 - 1, z0 + nz_local + 1, dev)
    local = [(t.sigma[z0 : z0 + nz_local].to(dev), t.u[:, z0 : z0 + nz_local].to(dev), t.t) for t in targets]
    inv = float(np.float32(1.0 / len(targets)))
    inv_n = float(ops_loss.inv_n_f32(g))
    ws_d, wu_d = float(np.float32(w_data.w_sigma)), float(np.float32(w_data.w_u))
    ws_p, wu_p = float(np.float32(w_phys.w_sigma)), float(np.float32(w_phys.w_u))
    pw = float(np.float32(phys_weight))

    def loss_and_grad(params):
        with torch.enable_grad():
            leaves = tree.leaves(params)
            p = tree.unflatten(params, [x.detach().requires_grad_() for x in leaves])
            total = 0.0
            for sigma, u, tt in local:
                out = _rows_output(g, model_cfg, p, tt, own)
                ds = out[..., 0] - sigma
                du = torch.movedim(out[..., 1:4], -1, 0) - u
                total = total + ws_d * torch.sum(ds * ds) * inv_n + wu_d * torch.sum(du * du) * inv_n
                if phys_weight:
                    rs, ru = ops_stencil.residuals_zext(g, *_rows_snapshots(g, model_cfg, p, tt, ext))
                    total = total + pw * (ws_p * torch.sum(rs * rs) * inv_n + wu_p * torch.sum(ru * ru) * inv_n)
            total = total * inv
            pl = tree.leaves(p)
            gl = torch.autograd.grad(total, pl, allow_unused=True)
        gl = [mesh.all_reduce(torch.zeros_like(x) if gr is None else gr) for gr, x in zip(gl, pl)]
        return mesh.all_reduce(total), tree.unflatten(params, gl)

    return loss_and_grad


def _sharded_mega_loss_and_grad(g, model_cfg, targets, mesh, w_data, phys_weight, w_phys, precision):
    """(params) -> (loss, grads) through the kernels' shard-local launches
    (JAX _make_sharded_fit_step_mega): K6 / K7 on each rank's rows for the
    data term, K4 / K5's shard-local builds for the physics term."""
    from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_loss_and_grad_sharded
    from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_loss_and_grad_sharded
    from phys_autodiff_tpu_torch.parallel.mesh import shard_rows

    if isinstance(model_cfg, MLPGridConfig):
        lag = kfit.fit_loss_and_grad_sharded(g, model_cfg, mesh, w_data, precision)
        plag = mega_loss_and_grad_sharded(g, w_phys, model_cfg, mesh, precision) if phys_weight else None
    else:
        lag = kfit.ngp_fit_loss_and_grad_sharded(g, model_cfg, mesh, w_data, precision)
        plag = ngp_loss_and_grad_sharded(g, w_phys, model_cfg, mesh, precision) if phys_weight else None
    packed = [(shard_rows(mesh, kfit.pack_target(g, t.sigma, t.u)), t.t) for t in targets]
    inv = float(np.float32(1.0 / len(targets)))
    pw = float(np.float32(phys_weight))

    def loss_and_grad(params):
        total, acc = 0.0, None
        for pk, tt in packed:
            ld, (gd, _) = lag(params, pk, tt)
            total = total + ld
            acc = tree.leaves(gd) if acc is None else [a + b for a, b in zip(acc, tree.leaves(gd))]
            if phys_weight:
                lp, (gp, _) = plag(params, tt)
                total = total + pw * lp
                acc = [a + pw * b for a, b in zip(acc, tree.leaves(gp))]
        return total * inv, tree.unflatten(params, [x * inv for x in acc])

    return loss_and_grad


def make_sharded_fit_step(
    g: GridSpec,
    model_cfg,
    targets: Sequence[FitTarget],
    mesh,
    cfg: TrainConfig = TrainConfig(),
    w_data: PhysWeights = PhysWeights(),
    phys_weight: float = 0.0,
    w_phys: PhysWeights = PhysWeights(),
    engine: str = "auto",
):
    """Supervised fitting over a z mesh (parallel/mesh.ZMesh): the params
    replicated, each rank holding its rows of the targets (given whole; a
    rank keeps its own rows) and of the model's output; the composite of
    make_fit_loss, its gradients all-reduced.

    engine (as _resolve_fit_engine decides it, on the mesh's device): "mega"
    runs K6 / K7 on each rank's rows (kernels/fit.fit_loss_and_grad_sharded,
    ngp_fit_loss_and_grad_sharded) and, for the composite, the shard-local
    builds of K4 / K5; "xla" is autograd of each rank's part of the staged
    loss. Returns (step, init): init(params=None) -> a TrainState on the
    mesh's device (init_any(model_cfg, cfg.seed) when params is None);
    step(state) -> (state', loss), the loss that of the params before the
    update."""
    if not targets:
        raise ValueError("need at least one FitTarget")
    targets = list(targets)
    eng = _resolve_fit_engine(engine, g, model_cfg, phys_weight, mesh.device.type == "cuda", cfg.precision)
    if eng == "mega":
        loss_and_grad = _sharded_mega_loss_and_grad(g, model_cfg, targets, mesh, w_data, phys_weight, w_phys,
                                                    cfg.precision)
    else:
        loss_and_grad = _sharded_xla_loss_and_grad(g, model_cfg, targets, mesh, w_data, phys_weight, w_phys)
    schedule = make_schedule(cfg)

    def step(state):
        loss, grads = loss_and_grad(state.params)
        return _apply_grads(cfg, schedule, state, grads), loss

    def init(params=None):
        if params is None:
            params = init_any(model_cfg, seed=cfg.seed, device=mesh.device)
        return state_from_params(cfg, tree.map_tree(lambda x: x.to(mesh.device), params))

    return step, init
