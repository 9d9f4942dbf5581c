"""Hand-written sm_90a CUDA kernels of the port, each beside its plain
PyTorch version (sources in ../csrc/, built by _build.py at first use).

  residuals  K1: fused transport residuals / scaled backward / loss partials
             (replaces the three pallas_call sites of pallas/residuals.py)
  mlp        K2: fused MLP field generation (replaces pallas/mlp.py)
  mega       K3: MLP -> residual -> loss partials (replaces pallas/mega.py)
  mega_bwd   K4: the loss and every MLP table gradient in one call
             (replaces pallas/mega_bwd.py); mega_loss_and_grad pulls them
             back to the params and t
  mega_ngp   K5: the loss and every head / encoding gradient of the
             encoded-field model in one call (replaces pallas/mega_ngp.py);
             ngp_loss_and_grad pulls them back to the tables, params and t
  fit        K6 / K7: the supervised-fit loss and gradients of the MLP and
             of the encoded field (replaces pallas/fit.py)
  transport  K8: one semi-Lagrangian step of C scalars through u, and the
             step from six precomputed weight planes (replaces the three
             pallas_call sites of pallas/transport.py)
  probe      P1: x + 1 over one plane, the per-launch floor probe (replaces
             scripts/small_grid_experiments.py's bound_min_call)

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. The precision tiers each kernel runs are
_build.TIERS: K2, K3, K4 and K6 run "bf16" (layer 2 on the tensor cores,
csrc/mlp_mma.cuh; K2 also "bf16x3") and "f32_high" as f32, K1 and the NGP
kernels K5 and K7 "f32" (models/ngp.py); a tier still to port raises
NotImplementedError naming its kernel. K1-K3's
residual, loss and field entry points and K8's step are differentiable:
autograd.Functions whose backward is autograd through the staged ops or the
plain version (the JAX custom_vjps); K4 to K7 are themselves gradients; K8's
weights form and P1 are forward-only.
"""

from phys_autodiff_tpu_torch.kernels.mega import mega_loss_pipeline
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_loss_and_grad
from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_loss_and_grad
from phys_autodiff_tpu_torch.kernels.mlp import (
    fused_loss_pipeline,
    generate_fields_fused,
    generate_fields_fused_packed,
    grid_infer_fused,
)
from phys_autodiff_tpu_torch.kernels.residuals import (
    PACKED_ORDER,
    loss_backward_fused,
    loss_backward_fused_packed,
    loss_forward_fused,
    loss_forward_fused_packed,
    pack_fields,
    residuals_fused,
    residuals_fused_packed,
    residuals_fused_packed_bf16,
    residuals_fused_packed_mixed_out,
    unpack_fields,
)
from phys_autodiff_tpu_torch.kernels.transport import (
    transport_step_fused,
    transport_step_fused_pre,
    transport_step_many_fused,
    transport_weights,
)

__all__ = [
    "PACKED_ORDER",
    "pack_fields",
    "unpack_fields",
    "residuals_fused",
    "loss_backward_fused",
    "loss_forward_fused",
    "residuals_fused_packed",
    "residuals_fused_packed_bf16",
    "residuals_fused_packed_mixed_out",
    "loss_backward_fused_packed",
    "loss_forward_fused_packed",
    "generate_fields_fused",
    "generate_fields_fused_packed",
    "grid_infer_fused",
    "fused_loss_pipeline",
    "mega_loss_pipeline",
    "mega_loss_and_grad",
    "ngp_loss_and_grad",
    "transport_step_fused",
    "transport_step_many_fused",
    "transport_step_fused_pre",
    "transport_weights",
]
