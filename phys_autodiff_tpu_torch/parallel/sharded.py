"""The z-sharded paths on torch.distributed (port of
phys_autodiff_tpu/parallel/sharded.py).

Each rank of a ZMesh (parallel/mesh.py) owns a contiguous block of z rows.
Two arms, as in the JAX package:

  * The staged arm (`residuals_sharded`, `make_sharded_train_step`; the JAX
    package's "GSPMD arm"). PyTorch has no partitioner, so each rank does
    by hand what XLA inserts there: it exchanges halo planes
    (residuals_sharded) or generates the fields of its own rows and one
    halo row a side from the replicated MLP (the train step), runs the
    staged ops, takes its local gradients by autograd, and all-reduces
    them explicitly (autograd does not see the collective).
  * The generic step (`make_generic_sharded_train_step`) for any field
    generator, and the 2-D step (`make_sharded_train_step_2d`) on a (z, h)
    mesh, the MLP's hidden units split over h: both staged, each rank's
    loss part and gradients by autograd, the collectives explicit.
  * The kernel arm: K1 on a halo-extended slab (`residuals_fused_sharded`,
    `loss_forward_fused_sharded`: the halo planes exchanged with
    batch_isend_irecv), and the sharded fused training step
    (`make_sharded_fused_train_step`) on the shard-local build of K4
    (kernels/mega_bwd.mega_loss_and_grad_sharded) or on the slab-recompute
    gradient (train/slab_grad.make_slab_raw).

Losses reduce in a fixed order: raw plane (or slab) partials are gathered
and chained in global z order, so a sharded loss equals the single-device
loss on any mesh. Field arguments and results are a rank's rows
(parallel.mesh.shard_fields gives them).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_fits, mega_loss_and_grad_sharded, mega_supported
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS
from phys_autodiff_tpu_torch.kernels.residuals import plane_partials_fused, residuals_fused, sum_plane_partials
from phys_autodiff_tpu_torch.models import fields as fields_mod
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models.coords import _axis_coord, time_offset
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops import stencil as ops_stencil
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.parallel.mesh import Mesh2D, ZMesh
from phys_autodiff_tpu_torch.train.loop import TrainConfig, _apply_grads, make_schedule, state_from_params
from phys_autodiff_tpu_torch.train.slab_grad import make_slab_raw, slab_value_and_grad
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights

# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _halo_extend_z(mesh: ZMesh, f: torch.Tensor, periodic: bool, axis: int = 0) -> torch.Tensor:
    """A rank's z slab with one halo plane a side: the previous rank's top
    plane below, the next rank's bottom plane above, exchanged with
    batch_isend_irecv (JAX: lax.ppermute). One rank is its own neighbour
    both ways; NCCL and gloo refuse a send to oneself, so it takes its own
    planes. Clamped grids copy their own edge plane at global z = 0 and
    z = nz - 1 (the clamp rule)."""
    n = f.shape[axis]
    top = f.narrow(axis, n - 1, 1).contiguous()
    bot = f.narrow(axis, 0, 1).contiguous()
    lower, upper = _exchange_planes(mesh, top, bot)
    if not periodic:
        if mesh.rank == 0:
            lower = bot
        if mesh.rank == mesh.size - 1:
            upper = top
    return torch.cat([lower, f, upper], dim=axis)


def _exchange_planes(mesh: ZMesh, to_next: torch.Tensor, to_prev: torch.Tensor):
    """(from_prev, from_next): to_next goes to the next rank, to_prev to the
    previous one, around the ring (batch_isend_irecv; one rank keeps its
    own)."""
    if mesh.size == 1:
        return to_next, to_prev
    prev, nxt = mesh.peer((mesh.rank - 1) % mesh.size), mesh.peer((mesh.rank + 1) % mesh.size)
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [
        dist.P2POp(dist.isend, to_next, nxt, mesh.group, tag=0),
        dist.P2POp(dist.irecv, from_prev, prev, mesh.group, tag=0),
        dist.P2POp(dist.isend, to_prev, prev, mesh.group, tag=1),
        dist.P2POp(dist.irecv, from_next, nxt, mesh.group, tag=1),
    ]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _HaloExtendZ(torch.autograd.Function):
    """_halo_extend_z with its adjoint: the backward sends each halo plane's
    cotangent back to the plane's owner, which adds it to its edge plane;
    where the clamp copied a rank's own edge plane, the cotangent adds to
    that edge plane itself."""

    @staticmethod
    def forward(ctx, mesh, f, periodic, axis):
        ctx.mesh, ctx.periodic, ctx.axis = mesh, periodic, axis
        return _halo_extend_z(mesh, f, periodic, axis)

    @staticmethod
    def backward(ctx, d_ext):
        mesh, axis = ctx.mesh, ctx.axis
        n = d_ext.shape[axis] - 2
        d_lower = d_ext.narrow(axis, 0, 1).contiguous()  # the previous rank's top plane (or a clamped copy)
        d_upper = d_ext.narrow(axis, n + 1, 1).contiguous()  # the next rank's bottom plane (or a clamped copy)
        first = not ctx.periodic and mesh.rank == 0
        last = not ctx.periodic and mesh.rank == mesh.size - 1
        from_prev, from_next = _exchange_planes(mesh, torch.zeros_like(d_upper) if last else d_upper,
                                                torch.zeros_like(d_lower) if first else d_lower)
        d_f = d_ext.narrow(axis, 1, n).clone()
        bottom, top = d_f.narrow(axis, 0, 1), d_f.narrow(axis, n - 1, 1)
        bottom += from_prev  # our bottom plane was the previous rank's upper halo
        top += from_next  # our top plane was the next rank's lower halo
        if first:
            bottom += d_lower
        if last:
            top += d_upper
        return None, d_f, None, None


def halo_extend_z_diff(mesh: ZMesh, f: torch.Tensor, periodic: bool, axis: int = 0) -> torch.Tensor:
    """_halo_extend_z that autograd differentiates across the ranks (the
    adjoint's exchange runs in the backward): every halo of the sharded
    apps (transport, the pencil FFT's stencils, the Euler rollout and the
    masked CGNR's operator, whose transpose torch.autograd.grad takes).
    Every rank must run the backward, as it ran the forward."""
    return _HaloExtendZ.apply(mesh, f, periodic, axis)


def _local_grid(g: GridSpec, nz_local: int) -> GridSpec:
    """The grid of a halo-extended slab: the global grid (its scheme and
    boundary included) with nz = nz_local + 2. The kept rows ext[1:-1] read
    only ext[0:-2] and ext[2:], so the z boundary rule never fires for
    them; x and y keep the global wrap or clamp."""
    return dataclasses.replace(g, nz=nz_local + 2)


def _halo_extend_fields(mesh: ZMesh, fs_local: FieldSnapshots, periodic: bool) -> FieldSnapshots:
    return FieldSnapshots(
        *(_halo_extend_z(mesh, f, periodic, 0 if name.startswith("sigma") else 1)
          for name, f in zip(FieldSnapshots._fields, fs_local))
    )


# ---------------------------------------------------------------------------
# The staged arm
# ---------------------------------------------------------------------------


def residuals_sharded(g: GridSpec, mesh: ZMesh, fs_local: FieldSnapshots):
    """The staged residuals of this rank's rows: (R_sigma [nz_local, ny, nx],
    R_u [3, nz_local, ny, nx]) from its rows of the fields, the halo planes
    exchanged."""
    g_loc = _local_grid(g, mesh.rows(g.nz)[1])
    rs, ru = ops_stencil.residuals(g_loc, _halo_extend_fields(mesh, fs_local, g.periodic))
    return rs[1:-1], ru[:, 1:-1]


def row_outputs(g: GridSpec, mcfg: MLPGridConfig, params: mlp.Params, ts, rows: torch.Tensor) -> torch.Tensor:
    """The coordinate MLP's output [S, R, ny, nx, 4] at the times ts [S] on
    the given global z rows (wrapped or clamped): the coordinates that
    models.fields builds for the whole grid, at those rows."""
    return mlp.forward(params, _row_coords(g, mcfg, ts, rows, params["W1"].device))


def _row_coords(g: GridSpec, mcfg: MLPGridConfig, ts, rows: torch.Tensor, dev) -> torch.Tensor:
    """The MLP's inputs [S, R, ny, nx, 4] at the times ts on the given rows."""
    cx, cy = _axis_coord(g.nx, mcfg.norm, dev), _axis_coord(g.ny, mcfg.norm, dev)
    cz = _axis_coord(g.nz, mcfg.norm, dev)[rows]
    shape = (rows.shape[0], g.ny, g.nx)
    spatial = torch.stack([cx[None, None, :].expand(shape), cy[None, :, None].expand(shape),
                           cz[:, None, None].expand(shape)], dim=-1)
    t_in = torch.tensor(np.float32(time_offset(mcfg.norm)), device=dev) + torch.as_tensor(ts, device=dev)
    s = t_in.shape[0]
    return torch.cat([spatial[None].expand((s,) + spatial.shape),
                      t_in[:, None, None, None, None].expand((s,) + shape + (1,))], dim=-1)


def _row_fields(g: GridSpec, mcfg: MLPGridConfig, params: mlp.Params, t, rows: torch.Tensor):
    """models.fields.generate_fields at the given rows: sigma [3, R, ny, nx],
    u [3, 3, R, ny, nx] of the slices t-dt, t, t+dt."""
    return fields_mod.split_channels(row_outputs(g, mcfg, params, fields_mod.slice_times(t, g.dt), rows))


def _make_step(cfg: TrainConfig, mesh: ZMesh, loss_and_grad):
    """(step, init) around loss_and_grad(params, t) -> (loss, grads): the
    port's training update (train/loop.py: adam and its schedule), the
    state replicated on every rank. init(params) -> a TrainState on the
    mesh's device; step(state, t) -> (state', loss), the loss that of the
    params before the update. (The JAX package's (params, opt_state) pair
    is one TrainState here, as in train/loop.py.)"""
    schedule = make_schedule(cfg)

    def step(state, t):
        loss, grads = loss_and_grad(state.params, t)
        return _apply_grads(cfg, schedule, state, grads), loss

    def init(params):
        return state_from_params(cfg, {k: v.to(mesh.device) for k, v in params.items()})

    return step, init


def make_sharded_train_step(g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, mesh: ZMesh,
                            learning_rate: float = 1e-3):
    """The staged sharded training step: params replicated, each rank's
    residuals from the fields of its rows and one halo row a side (generated
    from the replicated MLP), its loss part and local gradients by autograd,
    then an explicit all-reduce of the gradients and the loss (JAX: the
    partitioner's psum). Returns (step, init), see _make_step."""
    z0, nz_local = mesh.rows(g.nz)
    inv_n = float(ops_loss.inv_n_f32(g))
    ws, wu = float(np.float32(w.w_sigma)), float(np.float32(w.w_u))

    def loss_and_grad(params, t):
        rows = ops_stencil.z_rows(g, z0 - 1, z0 + nz_local + 1, mesh.device)
        with torch.enable_grad():
            p = {k: params[k].detach().requires_grad_() for k in _PARAM_KEYS}
            sigma, u = _row_fields(g, mcfg, p, t, rows)
            rs, ru = ops_stencil.residuals_zext(g, sigma, u)
            loss = ws * inv_n * torch.sum(rs * rs) + wu * inv_n * torch.sum(ru * ru)
            grads = torch.autograd.grad(loss, [p[k] for k in _PARAM_KEYS])
        return mesh.all_reduce(loss), {k: mesh.all_reduce(gr) for k, gr in zip(_PARAM_KEYS, grads)}

    return _make_step(TrainConfig(learning_rate=learning_rate), mesh, loss_and_grad)


def _zext_loss(g: GridSpec, w: PhysWeights, sigma: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A rank's part of ops.total_loss from its rows and one halo row a side
    (sigma [3, R, ny, nx], u [3, 3, R, ny, nx]): the whole grid's weights
    and 1/N, the sums over the rank's rows."""
    ls, lu = ops_loss.loss_terms(g, w, *ops_stencil.residuals_zext(g, sigma, u))
    return ls + lu


def make_generic_sharded_train_step(g: GridSpec, w: PhysWeights, generate_fn, mesh: ZMesh, params0,
                                    learning_rate: float = 1e-3):
    """The sharded training step of any differentiable field generator
    generate_fn(params, t) -> FieldSnapshots of the WHOLE grid (the
    multi-rank train/loop.make_generic_train_step: the NGP field, the
    solenoidal head): params replicated, each rank keeping its rows and one
    halo row a side of the generated fields, its loss part and local
    gradients by autograd, the gradients all-reduced and the loss summed
    from the ranks' parts in rank order. Every rank generates the whole
    grid: the generation is replicated work (the JAX partitioner may do the
    same; what is generic here is the generator), the residuals and the
    loss are split. Returns (step, init): init(params=None) -> a TrainState
    of params0 (or params) on the mesh's device; step(state, t) -> (state',
    loss), the loss that of the params before the update."""
    z0, nz_local = mesh.rows(g.nz)
    cfg = TrainConfig(learning_rate=learning_rate)
    schedule = make_schedule(cfg)

    def loss_and_grad(params, t):
        rows = ops_stencil.z_rows(g, z0 - 1, z0 + nz_local + 1, mesh.device)
        with torch.enable_grad():
            p = tree.map_tree(lambda x: x.detach().requires_grad_(), params)
            fs = generate_fn(p, t)
            sigma = torch.stack([fs.sigma_tm1, fs.sigma_t, fs.sigma_tp1])[:, rows]
            u = torch.stack([fs.u_tm1, fs.u_t, fs.u_tp1])[:, :, rows]
            loss = _zext_loss(g, w, sigma, u)
            leaves = tree.leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [mesh.all_reduce(torch.zeros_like(x) if gr is None else gr) for gr, x in zip(grads, leaves)]
        return mesh.chain_sum(loss.detach()), tree.unflatten(params, grads)

    def step(state, t):
        loss, grads = loss_and_grad(state.params, t)
        return _apply_grads(cfg, schedule, state, grads), loss

    def init(params=None):
        return state_from_params(cfg, tree.map_tree(lambda x: x.to(mesh.device), params0 if params is None else params))

    return step, init


class _SumOverH(torch.autograd.Function):
    """The sum of the h ranks' partial products: an all-reduce forward and
    the identity backward. Every h rank computes the same loss from the
    sum, so each owes its partial product the whole cotangent;
    torch.distributed.nn.functional.all_reduce would all-reduce the
    cotangent too and scale the gradients by the h size."""

    @staticmethod
    def forward(ctx, mesh, y):
        out = y.detach().clone().contiguous()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, d_out):
        return None, d_out


def shard_params_2d(mesh2: Mesh2D, params: mlp.Params) -> mlp.Params:
    """This rank's shards of the MLP's params on the (z, h) mesh: W1 and b1
    by columns over h, W2 by rows over h, b2 replicated (the JAX package's
    P(None, "h"), P("h"), P("h", None), P())."""
    hm = mesh2.h
    h = params["W1"].shape[1]
    if h % hm.size:
        raise ValueError(f"H={h} must divide over the {hm.size}-way 'h' axis")
    c0, hl = hm.rank * (h // hm.size), h // hm.size
    out = {"W1": params["W1"][:, c0:c0 + hl], "b1": params["b1"][c0:c0 + hl], "W2": params["W2"][c0:c0 + hl],
           "b2": params["b2"]}
    return {k: v.to(mesh2.device).contiguous() for k, v in out.items()}


def gather_params_2d(mesh2: Mesh2D, params: mlp.Params) -> mlp.Params:
    """The whole params from every h rank's shards (shard_params_2d's
    inverse)."""
    hm = mesh2.h
    return {"W1": hm.all_gather(params["W1"], 1), "b1": hm.all_gather(params["b1"], 0),
            "W2": hm.all_gather(params["W2"], 0), "b2": params["b2"].detach().clone()}


def make_sharded_train_step_2d(g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, mesh2: Mesh2D,
                               learning_rate: float = 1e-3):
    """The staged training step on a (z, h) mesh (parallel/mesh.Mesh2D):
    spatial data parallelism over the grid's z rows and tensor parallelism
    over the MLP's hidden units. A rank holds its shards (shard_params_2d)
    and computes, for its z rows and one halo row a side, layer 1 on its
    hidden units and layer 2's partial product, summed over h by an
    all-reduce whose backward is the identity (_SumOverH); then its loss
    part and its shards' gradients by autograd. The gradients and the loss
    are reduced over z only (the loss in rank order); Adam runs on each
    rank's shards. The JAX package leaves the partial sums and the psum to
    the partitioner; here they are written out. Returns (step, init):
    init(params) -> a TrainState of this rank's shards of the whole params;
    step(state, t) -> (state', loss)."""
    zm, hm = mesh2.z, mesh2.h
    z0, nz_local = zm.rows(g.nz)
    if mcfg.dims.H % hm.size:
        raise ValueError(f"H={mcfg.dims.H} must divide over the {hm.size}-way 'h' axis")
    cfg = TrainConfig(learning_rate=learning_rate)
    schedule = make_schedule(cfg)

    def loss_and_grad(params, t):
        rows = ops_stencil.z_rows(g, z0 - 1, z0 + nz_local + 1, mesh2.device)
        with torch.enable_grad():
            p = {k: params[k].detach().requires_grad_() for k in _PARAM_KEYS}
            x = _row_coords(g, mcfg, fields_mod.slice_times(t, g.dt), rows, mesh2.device)
            a1 = torch.clamp_min(torch.matmul(x, p["W1"]) + p["b1"], 0.0)
            y = _SumOverH.apply(hm, torch.matmul(a1, p["W2"])) + p["b2"]
            loss = _zext_loss(g, w, *fields_mod.split_channels(y))
            grads = torch.autograd.grad(loss, [p[k] for k in _PARAM_KEYS])
        return zm.chain_sum(loss.detach()), {k: zm.all_reduce(gr) for k, gr in zip(_PARAM_KEYS, grads)}

    def step(state, t):
        loss, grads = loss_and_grad(state.params, t)
        return _apply_grads(cfg, schedule, state, grads), loss

    def init(params):
        return state_from_params(cfg, shard_params_2d(mesh2, params))

    return step, init


# ---------------------------------------------------------------------------
# The kernel arm
# ---------------------------------------------------------------------------


def residuals_fused_sharded(g: GridSpec, mesh: ZMesh, fs_local: FieldSnapshots, precision: str = "f32"):
    """K1 under explicit z-domain decomposition: each rank extends its slab
    with the exchanged halo planes, runs the residual kernel on it (the
    halos make its z edges the global stencil) and drops the halo rows:
    (R_sigma [nz_local, ny, nx], R_u [3, nz_local, ny, nx])."""
    g_loc = _local_grid(g, mesh.rows(g.nz)[1])
    rs, ru = residuals_fused(g_loc, _halo_extend_fields(mesh, fs_local, g.periodic), precision)
    return rs[1:-1], ru[:, 1:-1]


def loss_forward_fused_sharded(g: GridSpec, w: PhysWeights, mesh: ZMesh, fs_local: FieldSnapshots):
    """The fused loss on the mesh: the halo exchange, K1's raw plane
    partials on each rank's extended slab (no 1/N, no weights), the halo
    planes' partials dropped, the rest gathered in global z order and
    chained once (kernels/residuals.sum_plane_partials). Every plane's
    partial is the single-device kernel's, and the chain's association is
    the same on any mesh. Returns (L_sigma, L_u)."""
    g_loc = _local_grid(g, mesh.rows(g.nz)[1])
    parts = plane_partials_fused(g_loc, _halo_extend_fields(mesh, fs_local, g.periodic))[:, 1:-1]
    loss = sum_plane_partials(g, w, mesh.all_gather(parts.contiguous(), 1))
    return loss[0], loss[1]


def make_sharded_fused_train_step(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    mesh: ZMesh,
    learning_rate: float = 1e-3,
    precision: str = "f32",
    sz: int | None = None,
    backward: str = "auto",
):
    """The sharded fused training step: each rank computes its rows'
    gradient with everything recomputed locally (halo rows come from the
    replicated MLP, not from a neighbour); gradients are all-reduced and the
    loss chained from gathered partials in a fixed order.

    backward="mega" runs the shard-local build of K4 a rank
    (mega_loss_and_grad_sharded: one kernel for the loss and every
    gradient); "slab" runs the slab-recompute gradient
    (train/slab_grad.make_slab_raw), nz / sz / size slabs a rank, their raw
    sums and gradients gathered and added in slab order (so the loss and
    the gradient are the single-device slab gradient's, bit for bit, on any
    mesh; JAX psums the gradient); "auto" takes mega within K4's
    gate of the tier (mega_fits) when no slab height sz is given, else the
    slab arm. Returns (step, init), see _make_step."""
    if backward not in ("auto", "mega", "slab"):
        raise ValueError(f"backward must be 'auto', 'mega' or 'slab', not {backward!r}")
    tier = _build.check_precision(precision, "K4")
    cfg = TrainConfig(learning_rate=learning_rate)
    use_mega = backward == "mega" or (
        backward == "auto" and sz is None and mega_supported(g) and mega_fits(g, mcfg.dims.H, tier)
    )
    if use_mega:
        lg = mega_loss_and_grad_sharded(g, w, mcfg, mesh, precision)

        def mega_loss_grad(params, t):
            loss, (grads, _) = lg(params, t)
            return loss, grads

        return _make_step(cfg, mesh, mega_loss_grad)
    slab_raw, sz = make_slab_raw(g, w, mcfg, sz, precision)
    n_slabs = g.nz // sz
    if n_slabs % mesh.size != 0:
        raise ValueError(f"{n_slabs} slabs (sz={sz}) must divide over {mesh.size} shards")
    per_shard = n_slabs // mesh.size
    inv_n = float(ops_loss.inv_n_f32(g))

    def slab_loss_grad(params, t):
        parts, grads = [], {k: [] for k in _PARAM_KEYS}
        for j in range(per_shard):
            lk, (gk, _) = slab_value_and_grad(slab_raw, params, t, mesh.rank * per_shard + j)
            parts.append(lk)
            for k in _PARAM_KEYS:
                grads[k].append(gk[k])
        # every slab's loss and gradient gathered and added in slab order:
        # the single-device slab gradient's sums, on any mesh
        all_parts = mesh.all_gather(torch.stack(parts), 0)  # [n_slabs]
        raw_l = all_parts.new_zeros(())
        for i in range(n_slabs):
            raw_l = raw_l + all_parts[i]
        out = {}
        for k in _PARAM_KEYS:
            per_slab = mesh.all_gather(torch.stack(grads[k]), 0)  # [n_slabs, ...]
            acc = per_slab[0]
            for i in range(1, n_slabs):
                acc = acc + per_slab[i]
            out[k] = acc * inv_n
        return raw_l * inv_n, out

    return _make_step(cfg, mesh, slab_loss_grad)
