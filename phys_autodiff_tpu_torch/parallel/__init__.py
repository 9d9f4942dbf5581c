"""Multi-device execution over the grid's z axis (port of
phys_autodiff_tpu/parallel/): the z mesh and the (z, h) mesh (mesh.py), the
sharded paths (sharded.py) and the pencil FFT (spectral.py) on
torch.distributed."""

from phys_autodiff_tpu_torch.parallel.mesh import (
    H_AXIS,
    Z_AXIS,
    Mesh2D,
    ZMesh,
    make_mesh,
    make_mesh_2d,
    shard_fields,
    shard_rows,
)
from phys_autodiff_tpu_torch.parallel.sharded import (
    loss_forward_fused_sharded,
    make_generic_sharded_train_step,
    make_sharded_fused_train_step,
    make_sharded_train_step,
    make_sharded_train_step_2d,
    residuals_fused_sharded,
    residuals_sharded,
)

__all__ = [
    "Z_AXIS",
    "H_AXIS",
    "ZMesh",
    "Mesh2D",
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "shard_fields",
    "residuals_sharded",
    "make_sharded_train_step",
    "residuals_fused_sharded",
    "loss_forward_fused_sharded",
    "make_sharded_fused_train_step",
    "make_generic_sharded_train_step",
    "make_sharded_train_step_2d",
]
