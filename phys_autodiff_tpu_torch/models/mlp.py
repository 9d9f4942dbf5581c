"""The 2-layer coordinate MLP: [x, y, z, t] -> [sigma, ux, uy, uz]
(port of phys_autodiff_tpu/models/mlp.py).

    y = relu(x @ W1 + b1) @ W2 + b2

Parameters keep the JAX layout: W1 [In, H], b1 [H], W2 [H, Out], b2 [Out].
`init_params` draws from the same seeded numpy MT19937 stream as the JAX
package, so one seed gives bitwise-equal weights in both packages.
`params_from_jax` carries a JAX parameter dict (as numpy arrays) across.
Every function that places tensors puts them on the card unless the caller
passes another `device` (the CPU tests pass device="cpu").
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from phys_autodiff_tpu_torch.utils.config import MLPDims

Params = Dict[str, torch.Tensor]


def init_params(dims: MLPDims, seed: int = 42, scale: float = 0.5, device="cuda", dtype=torch.float32) -> Params:
    """Uniform(-scale, scale) init, fill order W1, b1, W2, b2 like the
    reference, drawn in the reference layout ([H, In] then [Out, H]) and
    transposed to [In, H] / [H, Out]. The float32 draws are cast to
    `dtype`, as the JAX package's init_params(dtype=) does; the kernels take
    float32 params only (kernels/_build.uses_kernel)."""
    rng = np.random.Generator(np.random.MT19937(seed))

    def draw(*shape):
        return rng.uniform(-scale, scale, size=shape).astype(np.float32)

    w1 = draw(dims.H, dims.In).T
    b1 = draw(dims.H)
    w2 = draw(dims.Out, dims.H).T
    b2 = draw(dims.Out)
    params = params_from_jax({"W1": w1, "b1": b1, "W2": w2, "b2": b2}, device)
    if dtype != torch.float32:
        params = {k: v.to(dtype) for k, v in params.items()}
    return params


def params_from_jax(np_params, device="cuda") -> Params:
    """A JAX parameter dict (numpy or array-like leaves, JAX layout) ->
    contiguous float32 tensors on `device`."""
    return {
        k: torch.tensor(np.ascontiguousarray(np_params[k], dtype=np.float32), device=device)
        for k in ("W1", "b1", "W2", "b2")
    }


def to_reference_layout(params: Params) -> dict[str, np.ndarray]:
    """Port layout -> reference row-major layout: W1 [H, In], b1 [H],
    W2 [Out, H], b2 [Out] (numpy)."""
    return {
        "W1": params["W1"].detach().cpu().numpy().T.copy(),
        "b1": params["b1"].detach().cpu().numpy().copy(),
        "W2": params["W2"].detach().cpu().numpy().T.copy(),
        "b2": params["b2"].detach().cpu().numpy().copy(),
    }


def from_reference_layout(ref: dict[str, np.ndarray], device="cuda") -> Params:
    return params_from_jax(
        {
            "W1": np.asarray(ref["W1"]).T,
            "b1": ref["b1"],
            "W2": np.asarray(ref["W2"]).T,
            "b2": ref["b2"],
        },
        device,
    )


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """y = relu(x @ W1 + b1) @ W2 + b2.  x: [..., In] -> y: [..., Out].

    On a CUDA device the matmuls must run in full float32: callers keep
    torch.backends.cuda.matmul.allow_tf32 False (PyTorch's default)."""
    z1 = torch.matmul(x, params["W1"]) + params["b1"]
    a1 = torch.clamp_min(z1, 0.0)
    return torch.matmul(a1, params["W2"]) + params["b2"]


def mse_loss(params: Params, x: torch.Tensor, y_target: torch.Tensor) -> torch.Tensor:
    """The reference backward's hard-coded head: L = mean((y - y_t)^2) over
    B*Out (src/mlp_cpu.cpp:56-58)."""
    y = forward(params, x)
    return torch.mean((y - y_target) ** 2)


def mse_grads(params: Params, x: torch.Tensor, y_target: torch.Tensor) -> Params:
    """d mse_loss / d params (the reference's dW1/db1/dW2/db2), as a dict in
    the JAX layout."""
    return torch.func.grad(mse_loss)(params, x, y_target)


class MLP(nn.Module):
    """The MLP as an nn.Module holding W1/b1/W2/b2 in the JAX layout."""

    def __init__(self, params: Params):
        super().__init__()
        self.W1 = nn.Parameter(params["W1"])
        self.b1 = nn.Parameter(params["b1"])
        self.W2 = nn.Parameter(params["W2"])
        self.b2 = nn.Parameter(params["b2"])

    def params(self) -> Params:
        return {"W1": self.W1, "b1": self.b1, "W2": self.W2, "b2": self.b2}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward(self.params(), x)
