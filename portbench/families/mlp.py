"""The coordinate MLP 4 -> H -> 4 (configurations with "family": "mlp"):
the port's MLPGridConfig, its weights, its training step (K4 and the
folds) and its least work. Its plain reference is reference/mlp.py.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.core import inputs, work


def model_config(config: dict):
    from phys_autodiff_tpu_torch.utils.config import CoordNorm, MLPDims, MLPGridConfig

    return MLPGridConfig(dims=MLPDims(**config["dims"]), norm=CoordNorm(config["norm"]))


def make_params(config: dict, seed: int, device) -> dict:
    """W1 [In, H], b1 [H], W2 [H, Out], b2 [Out], all U(-s, s) with s the
    configuration's init scale (the reference's init)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = config["dims"]
    shapes = {"W1": (d["In"], d["H"]), "b1": (d["H"],), "W2": (d["H"], d["Out"]), "b2": (d["Out"],)}
    return dict(inputs.draw(gen, shapes, config["init_scale"], device))


def train_step(config: dict, traffic: dict, g, w, model, cfg, params0: dict):
    """(step, state) of `train.loop.make_train_step`: the engine "mega" is
    the fused step, one K4 call a step."""
    from phys_autodiff_tpu_torch.train.loop import make_train_step, state_from_params

    cfg = dataclasses.replace(cfg, use_fused=traffic["engine"] == "mega")
    return make_train_step(g, w, model, cfg), state_from_params(cfg, params0)


def params_count(config: dict) -> int:
    d = config["dims"]
    return d["In"] * d["H"] + d["H"] + d["H"] * d["Out"] + d["Out"]


def kernel_work(kernel: str, config: dict) -> tuple[float, float] | None:
    nz, ny, nx = work.grid_shape(config)
    h = config["dims"]["H"]
    return {"K4": work.k4(nz, ny, nx, h), "grid_forward": work.grid_forward(nz, ny, nx, h)}.get(kernel)


def unit_flops(loop: str, config: dict) -> float | None:
    """A training step: K4, the folds and Adam; a served field: one grid
    forward."""
    if loop == "serve":
        return kernel_work("grid_forward", config)[1]
    if loop == "train":
        nz, ny, nx = work.grid_shape(config)
        return (kernel_work("K4", config)[1] + work.folds(nz, ny, nx, config["dims"]["H"])
                + work.ADAM_OPS * params_count(config))
    return None
