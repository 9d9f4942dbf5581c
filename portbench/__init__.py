"""The benchmark of phys_autodiff_tpu_torch on one NVIDIA H100: see README.md."""
