"""Support code of the port: its own config dataclasses, tolerances,
error metrics and snapshot export (copies of the JAX package's jax-free
modules), and timing on the card."""

from phys_autodiff_tpu_torch.utils import export, tolerances

__all__ = ["export", "tolerances"]
