"""Multi-device execution over the grid's z axis (port of
phys_autodiff_tpu/parallel/): the z mesh (mesh.py) and the sharded paths
(sharded.py) on torch.distributed."""

from phys_autodiff_tpu_torch.parallel.mesh import Z_AXIS, ZMesh, make_mesh, shard_fields, shard_rows
from phys_autodiff_tpu_torch.parallel.sharded import (
    loss_forward_fused_sharded,
    make_sharded_fused_train_step,
    make_sharded_train_step,
    residuals_fused_sharded,
    residuals_sharded,
)

__all__ = [
    "Z_AXIS",
    "ZMesh",
    "make_mesh",
    "shard_rows",
    "shard_fields",
    "residuals_sharded",
    "make_sharded_train_step",
    "residuals_fused_sharded",
    "loss_forward_fused_sharded",
    "make_sharded_fused_train_step",
]
