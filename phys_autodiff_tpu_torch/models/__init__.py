"""The model families: the coordinate MLP (grid coordinates, 3-slice field
generation) and the encoded-field (NGP) model with its hash and Fourier
encoders; point and grid serving for both (sample; the self-describing
checkpoints of either family are in modelio, and the divergence-free u = curl A
heads in solenoidal, each imported on its own)."""

from phys_autodiff_tpu_torch.models import coords, encoders, fields, fourier, hash_encoder, mlp, ngp, sample
from phys_autodiff_tpu_torch.models.coords import grid_coords
from phys_autodiff_tpu_torch.models.fields import generate_fields, grid_infer, split_channels
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig
from phys_autodiff_tpu_torch.models.sample import evaluate_points, evaluate_points_batched, grid_infer_any

__all__ = [
    "coords",
    "encoders",
    "fields",
    "fourier",
    "hash_encoder",
    "mlp",
    "ngp",
    "sample",
    "grid_coords",
    "generate_fields",
    "grid_infer",
    "split_channels",
    "FourierEncodingConfig",
    "HashEncodingConfig",
    "NGPFieldConfig",
    "evaluate_points",
    "evaluate_points_batched",
    "grid_infer_any",
]
