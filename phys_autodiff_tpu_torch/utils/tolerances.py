"""Tolerance doctrine, centralized (the port's own copy of
phys_autodiff_tpu/utils/tolerances.py).

Mirrors the reference's tolerance spec (REQUIREMENT.md:196-203 and the
per-test thresholds cited below). Any perf claim must also pass these.
"""

# CPU-f64 oracle vs discrete-analytic manufactured solution
# (reference: test/test_phys_cpu_ref.cpp:87)
ORACLE_VS_ANALYTIC_REL = 3e-4
ORACLE_VS_ANALYTIC_MAX = 1e-3

# f32 device path vs f64 oracle, R_sigma — loose because of float
# cancellation in the central time difference
# (reference: test/test_phys_cuda_nonfused_vs_cpu.cpp:86-88)
F32_VS_ORACLE_RSIGMA_REL = 3e-4
F32_VS_ORACLE_RSIGMA_MAX = 1e-3

# f32 device path vs f64 oracle, R_u and backward — tight
# (reference: test/test_phys_cuda_nonfused_vs_cpu.cpp:89-92,104-110)
F32_VS_ORACLE_RU_REL = 1e-7
F32_VS_ORACLE_RU_MAX = 1e-6

# fused (Pallas) vs staged (XLA) — both f32, same arithmetic
# (reference: test/test_phys_cuda_fused_vs_nonfused.cpp:74-77,102-105)
FUSED_VS_STAGED_REL = 1e-7
FUSED_VS_STAGED_MAX = 1e-6

# MLP grid inference parity (reference: test/test_mlp_grid_infer.cpp:24)
MLP_INFER_REL = 1e-6

# Loss parity, f64-reduced (reference: REQUIREMENT.md:196-203)
LOSS_REL = 1e-7

# Gradient parity (reference: REQUIREMENT.md:196-203)
GRAD_REL = 1e-6
GRAD_MAX = 1e-6

# Reduced-precision (bf16) paths (reference: REQUIREMENT.md:203)
BF16_REL = 1e-3

# Training trajectories of two implementations from shared params: the
# loss at each step, and the params' displacement from the shared start as
# a norm (Adam moves every component by about lr whatever its gradient, so
# an elementwise bound would grade float32 gradient noise). The values
# tests/test_torch_train.py writes out; tests/test_torch_resilient.py
# reads them here
TRAIN_LOSS_REL = 1e-5
TRAIN_MOVED_REL = 1e-3
