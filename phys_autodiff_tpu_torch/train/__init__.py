"""Training: the loop (loop.py: the coordinate-MLP step, the encoded-field
step through K5, the generic autograd step), the fused K3-forward /
K4-backward loss and the slab-recompute gradient (slab_grad.py), supervised field fitting (fit_field.py:
the data loss through K6 / K7), npz checkpoints in the JAX package's
format (checkpoint.py) and checkpoint-every-K training with auto-resume
(resilient.py)."""

from phys_autodiff_tpu_torch.train import checkpoint
from phys_autodiff_tpu_torch.train.loop import (
    TrainConfig,
    TrainState,
    fit,
    fit_scan,
    init_state,
    loss_fn,
    make_generic_train_step,
    make_ngp_train_step,
    make_optimizer,
    make_schedule,
    make_train_epoch,
    make_train_step,
    state_from_params,
)
from phys_autodiff_tpu_torch.train.slab_grad import make_fused_loss
from phys_autodiff_tpu_torch.train import fit_field, resilient
from phys_autodiff_tpu_torch.train.resilient import ResilienceConfig, fit_resilient

__all__ = [
    "ResilienceConfig",
    "TrainConfig",
    "TrainState",
    "checkpoint",
    "fit",
    "fit_field",
    "fit_resilient",
    "fit_scan",
    "init_state",
    "loss_fn",
    "make_fused_loss",
    "make_generic_train_step",
    "make_ngp_train_step",
    "make_optimizer",
    "make_schedule",
    "make_train_epoch",
    "make_train_step",
    "resilient",
    "state_from_params",
]
