"""The system under test: phys_autodiff_tpu_torch's configuration objects
built from a configuration file. Only the loops import the program, and
only through here and the entry points they drive."""

from __future__ import annotations

from pathlib import Path


def grid_spec(config: dict):
    from phys_autodiff_tpu_torch.utils.config import GridSpec

    return GridSpec(**config["grid"])


def phys_weights(config: dict):
    from phys_autodiff_tpu_torch.utils.config import PhysWeights

    return PhysWeights(**config["weights"])


def model_config(config: dict):
    """MLPGridConfig or NGPFieldConfig."""
    if config["family"] == "mlp":
        from phys_autodiff_tpu_torch.utils.config import CoordNorm, MLPDims, MLPGridConfig

        return MLPGridConfig(dims=MLPDims(**config["dims"]), norm=CoordNorm(config["norm"]))
    from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig

    enc = {k: v for k, v in config["encoding"].items() if k != "init_scale"}
    return NGPFieldConfig(encoding=HashEncodingConfig(**enc), hidden=config["hidden"], out=config["out"])


def kernel_names() -> frozenset:
    """The names of the program's hand-written CUDA kernels (every
    `__global__` function in its csrc/)."""
    import re

    import phys_autodiff_tpu_torch

    csrc = Path(phys_autodiff_tpu_torch.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")
    return frozenset(n for p in sorted(csrc.glob("*.cu*")) for n in pat.findall(p.read_text()))
