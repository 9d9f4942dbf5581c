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


@dataclasses.dataclass(frozen=True)
class ZMesh:
    """A 1-D mesh over the z axis: the process group, this process's rank in
    it, the group's size, the axis name and this rank's device."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis: str = Z_AXIS

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

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x (a new tensor)."""
        x = x.detach().clone().contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


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
