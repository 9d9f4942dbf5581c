"""Applications built on the framework (port of phys_autodiff_tpu/apps):

  * apps.advect    tracer-particle advection through a learned velocity field
  * apps.euler     the incompressible Euler smoke stepper (advect / buoyancy /
                   divergence-free projection) over transport and ops.projection
  * apps.transport gather-free semi-Lagrangian scalar advection on the grid
                   (K8 on the card)
"""

from phys_autodiff_tpu_torch.apps import advect, euler, transport  # noqa: F401

__all__ = ["advect", "euler", "transport"]
