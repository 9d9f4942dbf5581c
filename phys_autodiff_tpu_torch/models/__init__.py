"""The model families: the coordinate MLP (grid coordinates, 3-slice field
generation) and the encoded-field (NGP) model with its hash and Fourier
encoders."""

from phys_autodiff_tpu_torch.models import coords, encoders, fields, fourier, hash_encoder, mlp, ngp
from phys_autodiff_tpu_torch.models.fields import generate_fields, grid_infer, split_channels
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig

__all__ = [
    "coords",
    "encoders",
    "fields",
    "fourier",
    "hash_encoder",
    "mlp",
    "ngp",
    "generate_fields",
    "grid_infer",
    "split_channels",
    "FourierEncodingConfig",
    "HashEncodingConfig",
    "NGPFieldConfig",
]
