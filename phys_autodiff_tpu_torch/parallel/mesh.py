"""The z mesh: a process group over which the grid's z axis is split
(port of phys_autodiff_tpu/parallel/mesh.py).

The JAX package builds a 1-D jax.sharding.Mesh with one axis "z" and lets
shardings place the rows. PyTorch has no partitioner: each process (rank)
of a torch.distributed group holds its own contiguous block of z rows,
nz / size of them, rank r the rows [r nz_local, (r + 1) nz_local), and the
sharded functions (parallel/sharded.py, kernels/mega_bwd.py,
kernels/mega_ngp.py, kernels/fit.py) exchange halos and add gradients with
explicit collectives. Params and scalars are replicated. `ZMesh` holds the
group, this process's rank and the group's size, the axis name and the
device this rank computes on; its collectives are plain torch.distributed
calls (autograd does not see them).

The caller starts the group (torch.distributed.init_process_group): NCCL
for CUDA tensors, gloo for CPU tensors. With one rank NCCL and gloo refuse
a send to oneself, so the halo exchange takes the local planes there
(parallel/sharded.py _halo_extend_z).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots

Z_AXIS = "z"
H_AXIS = "h"


@dataclasses.dataclass(frozen=True)
class ZMesh:
    """A 1-D mesh over the z axis: the process group, this process's rank in
    it, the group's size, the axis name and this rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = Z_AXIS

    def peer(self, r: int) -> int:
        """The world rank of rank r of this mesh's group (point-to-point
        calls take world ranks)."""
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def rows(self, nz: int) -> tuple[int, int]:
        """(z0, nz_local): the first global row and the row count of this
        rank's block of a grid of nz rows."""
        if nz % self.size != 0:
            raise ValueError(f"nz={nz} must divide evenly over the {self.size}-way '{self.axis}' axis")
        nz_local = nz // self.size
        return self.rank * nz_local, nz_local

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's x concatenated along dim in rank order (global z order
        for row blocks)."""
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """The sum (or `op`, e.g. dist.ReduceOp.MAX) of every rank's x (a
        new tensor)."""
        x = x.detach().clone().contiguous()
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def chain_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x added in rank order, ((x_0 + x_1) +
        x_2) + ...: the same bits on every rank and on every run, which an
        all-reduce does not promise. Differentiable: every rank's part of a
        loss reads the sum, so the cotangent of x is the chain sum of the
        ranks' cotangents (every rank runs the backward)."""
        return _ChainSum.apply(self, x)


def _chain_sum(mesh: ZMesh, x: torch.Tensor) -> torch.Tensor:
    parts = mesh.all_gather(x.reshape((1,) + tuple(x.shape)), 0)
    acc = parts[0]
    for i in range(1, mesh.size):
        acc = acc + parts[i]
    return acc


class _ChainSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _chain_sum(mesh, x)

    @staticmethod
    def backward(ctx, d_sum):
        return None, _chain_sum(ctx.mesh, d_sum)


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A 2-D ("z", "h") mesh over the world group: world rank r sits at
    (r // h_size, r % h_size), as the JAX package's devices.reshape(z, h).
    `z` is this rank's z group (the ranks of its h index: spatial data
    parallelism over the grid's z rows), `h` its h group (the ranks of its z
    index: tensor parallelism over the MLP's hidden units). Each is a ZMesh
    over a subgroup; its rank and size are within the subgroup."""

    z: ZMesh
    h: ZMesh

    @property
    def device(self) -> torch.device:
        return self.z.device

    @property
    def shape(self) -> dict:
        return {self.z.axis: self.z.size, self.h.axis: self.h.size}


def make_mesh_2d(h_size: int, device="cuda") -> Mesh2D:
    """The (z, h) mesh over the started process group with h_size ranks on
    the h axis. Every rank makes every subgroup, in the same order
    (dist.new_group is collective: a rank that skipped one would hang the
    others)."""
    world = make_mesh(device)
    if h_size < 1 or world.size % h_size:
        raise ValueError(f"the h axis ({h_size}) must divide the {world.size} ranks")
    z_size = world.size // h_size
    zi, hi = divmod(world.rank, h_size)
    z_groups = [dist.new_group([zz * h_size + hh for zz in range(z_size)]) for hh in range(h_size)]
    h_groups = [dist.new_group([zi_ * h_size + hh for hh in range(h_size)]) for zi_ in range(z_size)]
    return Mesh2D(z=ZMesh(group=z_groups[hi], rank=zi, size=z_size, device=world.device, axis=Z_AXIS),
                  h=ZMesh(group=h_groups[zi], rank=hi, size=h_size, device=world.device, axis=H_AXIS))


def make_mesh(device="cuda") -> ZMesh:
    """The 1-D z mesh over the started process group (the world group),
    computing on `device` (the card unless the caller asks for the CPU;
    "cuda" without an index takes this rank's card, rank modulo the cards
    of the host)."""
    if not dist.is_initialized():
        raise RuntimeError("start a process group first (torch.distributed.init_process_group)")
    group = dist.group.WORLD
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return ZMesh(group=group, rank=rank, size=size, device=dev)


def shard_rows(mesh: ZMesh, f: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a global field along `axis` (0 for a scalar field
    [nz, ny, nx], 1 for a vector field [3, nz, ny, nx]), on the mesh's
    device."""
    z0, n = mesh.rows(f.shape[axis])
    return f.narrow(axis, z0, n).to(mesh.device).contiguous()


def shard_fields(mesh: ZMesh, fields: FieldSnapshots) -> FieldSnapshots:
    """This rank's rows of every field of a FieldSnapshots."""
    return FieldSnapshots(
        *(shard_rows(mesh, f, 0 if name.startswith("sigma") else 1) for name, f in zip(FieldSnapshots._fields, fields))
    )
