"""The benchmark's plain reference: the models, the residual stencil, the
losses and Adam written out in plain PyTorch, in float64 (or, as the
control, in float32 with TF32 matmuls).

It imports neither jax nor anything of phys_autodiff_tpu or
phys_autodiff_tpu_torch, and takes nothing the program made: it works the
fields, the losses, the gradients and the updates out again from the
benchmark's own inputs (the seeded weights, the times, the target).
Everything runs in blocks of z planes, so a 256^3 grid fits beside nothing
else on one card.
"""
