"""phys_autodiff_tpu_torch — the PyTorch + CUDA port of phys_autodiff_tpu.

The forward (serving), training, fitting and simulation paths of the PINN
engine on an NVIDIA Hopper card:

  * models/   the 2-layer coordinate MLP, grid coordinates and the 3-slice
              field generation; the encoded-field (NGP) family: hash and
              Fourier encoders, their registry, and the decode head
              (plain PyTorch)
  * ops/      the staged stencil residuals and weighted-MSE loss (plain
              PyTorch; the referee of every kernel); the fluid ops
              (diagnostics, FFT / CGNR projection, implicit diffusion,
              obstacles)
  * kernels/  hand-written sm_90a CUDA kernels (sources in csrc/), each
              beside a plain PyTorch version of the same function:
              residuals (fused stencil), mlp (fused field generation),
              mega (MLP -> residual -> loss partials in one pass),
              mega_bwd (the loss and every parameter gradient in one call),
              mega_ngp (the same for the encoded-field model), fit (the
              supervised-fit gradients), transport (the semi-Lagrangian
              step), probe (the launch-floor probe)
  * apps/     semi-Lagrangian transport, the incompressible-Euler smoke
              solver and tracer-particle advection
  * train/    the training loop (TrainConfig, fit, make_ngp_train_step,
              make_generic_train_step; torch.optim in place of optax), the
              K3-forward / K4-backward loss, npz checkpoints in the JAX
              package's format
  * ref/      the float64 NumPy oracle of the loss
  * utils/    the config dataclasses, tolerances, error metrics, timing
  * entry.py  the flagship forward on a given torch.device

The package imports torch and never jax, and nothing of the JAX package: it
keeps its own copies of the jax-free config, tolerance, metric and oracle
modules. Entry points that place tensors put them on the card unless the
caller passes `device="cpu"`. Public functions keep the JAX layouts: W1
[In, H], W2 [H, Out], scalar fields [nz, ny, nx], vector fields
[3, nz, ny, nx], packed fields [12, nz, ny, nx] in PACKED_ORDER.
"""

from phys_autodiff_tpu_torch.utils.config import (
    CoordNorm,
    GridSpec,
    MLPDims,
    MLPGridConfig,
    PhysWeights,
)

__all__ = ["GridSpec", "PhysWeights", "MLPDims", "CoordNorm", "MLPGridConfig"]
