"""The flagship forward of the port (counterpart of __graft_entry__.entry).

entry(device) -> (fn, example_args): the single-kernel forward
(mega_loss_pipeline: MLP -> fields -> residuals -> loss partials ->
deterministic sum) of the flagship model, H=128, seed 777, t=0.25, on a
128x64x64 grid, with its parameters on `device`.
"""

from __future__ import annotations

import torch

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels.mega import mega_loss_pipeline
from phys_autodiff_tpu_torch.models import mlp

GRID = GridSpec(nx=128, ny=64, nz=64, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
WEIGHTS = PhysWeights()
CONFIG = MLPGridConfig(dims=MLPDims(H=128))
SEED = 777
T = 0.25


def entry(device: torch.device):
    params = mlp.init_params(CONFIG.dims, seed=SEED, device=device)

    def forward(params):
        l_sigma, l_u = mega_loss_pipeline(GRID, WEIGHTS, CONFIG, params, T)
        return l_sigma + l_u

    return forward, (params,)
