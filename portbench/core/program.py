"""The system under test: phys_autodiff_tpu_torch's configuration objects
built from a configuration file. Only the loops import the program, and
only through here, the model families (families/) and the entry points
they drive."""

from __future__ import annotations

from pathlib import Path

from portbench.core import specs


def grid_spec(config: dict):
    from phys_autodiff_tpu_torch.utils.config import GridSpec

    return GridSpec(**config["grid"])


def phys_weights(config: dict):
    from phys_autodiff_tpu_torch.utils.config import PhysWeights

    return PhysWeights(**config["weights"])


def model_config(config: dict):
    """The port's configuration object of the model (MLPGridConfig,
    NGPFieldConfig, ...): its family's `model_config`."""
    return specs.family(config["family"]).model_config(config)


def kernel_names() -> frozenset:
    """The names of the program's hand-written CUDA kernels (every
    `__global__` function in its csrc/)."""
    import re

    import phys_autodiff_tpu_torch

    csrc = Path(phys_autodiff_tpu_torch.__file__).resolve().parent / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")
    return frozenset(n for p in sorted(csrc.glob("*.cu*")) for n in pat.findall(p.read_text()))
