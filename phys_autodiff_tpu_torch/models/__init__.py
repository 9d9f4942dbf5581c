"""The model family: MLP, grid coordinates, 3-slice field generation."""

from phys_autodiff_tpu_torch.models import coords, fields, mlp
from phys_autodiff_tpu_torch.models.fields import generate_fields, grid_infer, split_channels

__all__ = ["coords", "fields", "mlp", "generate_fields", "grid_infer", "split_channels"]
