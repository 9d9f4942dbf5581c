"""The encoded field (configurations with "family": "ngp"): a
multiresolution hash encoding and a decode head, the port's
NGPFieldConfig, its weights, its training step (the encoder, K5, its
pull-back), its fit (K7) and its least work. Its plain reference is
reference/ngp.py.
"""

from __future__ import annotations

import math

import torch

from portbench.core import inputs, work
from portbench.reference.ngp import dense_levels, resolutions
from portbench.reference.train import unflatten


def model_config(config: dict):
    from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
    from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig

    enc = {k: v for k, v in config["encoding"].items() if k != "init_scale"}
    return NGPFieldConfig(encoding=HashEncodingConfig(**enc), hidden=config["hidden"], out=config["out"])


def make_params(config: dict, seed: int, device) -> dict:
    """The encoder's tables U(-s, s) (Instant-NGP's init, s = 1e-4), W1
    [LF + 1, H] and W2 [H, 4] Glorot-uniform, zero biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    enc = config["encoding"]
    f, t = enc["features_per_level"], 1 << enc["log2_table_size"]
    res, dense = resolutions(enc), dense_levels(enc)
    shapes = {"tables/hash": (enc["num_levels"] - len(dense), t, f)}
    shapes.update({f"tables/dense/l{l}": (res[l] + 1,) * 3 + (f,) for l in dense})
    pairs = inputs.draw(gen, shapes, enc["init_scale"], device)
    lf, h, o = enc["num_levels"] * f, config["hidden"], config["out"]
    lim1, lim2 = math.sqrt(6.0 / (lf + 1 + h)), math.sqrt(6.0 / (h + o))
    head = inputs.uniform(gen, (lf + 1) * h + h * o, device)
    pairs += [("W1", (head[: (lf + 1) * h] * lim1).reshape(lf + 1, h)),
              ("b1", torch.zeros(h, device=device)),
              ("W2", (head[(lf + 1) * h :] * lim2).reshape(h, o)),
              ("b2", torch.zeros(o, device=device))]
    like = {"tables": {"hash": 0, "dense": {f"l{l}": 0 for l in dense}}, "W1": 0, "b1": 0, "W2": 0, "b2": 0}
    if not dense:
        like["tables"].pop("dense")
    return unflatten(pairs, like)


def train_step(config: dict, traffic: dict, g, w, model, cfg, params0: dict):
    """(step, state) of `train.loop.make_ngp_train_step` with the traffic's
    engine as its backward ("mega": one K5 call a step)."""
    from phys_autodiff_tpu_torch.train.loop import make_ngp_train_step

    return make_ngp_train_step(g, w, model, cfg, params0, precision=config["precision"], backward=traffic["engine"])


def params_count(config: dict) -> int:
    enc = config["encoding"]
    f, dense = enc["features_per_level"], dense_levels(enc)
    tables = sum((r + 1) ** 3 * f if l in dense else (1 << enc["log2_table_size"]) * f
                 for l, r in enumerate(resolutions(enc)))
    lf, hn = enc["num_levels"] * f, config["hidden"]
    return tables + (lf + 1) * hn + hn + hn * config["out"] + config["out"]


def kernel_work(kernel: str, config: dict) -> tuple[float, float] | None:
    nz, ny, nx = work.grid_shape(config)
    enc = config["encoding"]
    lf, hn = enc["num_levels"] * enc["features_per_level"], config["hidden"]
    return {"K5": work.k5(nz, ny, nx, lf, hn), "K7": work.k7(nz, ny, nx, lf, hn)}.get(kernel)


def unit_flops(loop: str, config: dict) -> float | None:
    """A training step: K5, the encoder and its pull-back, and Adam; a
    fitting step: K7 in K5's place."""
    kernel = {"train": "K5", "fit": "K7"}.get(loop)
    if kernel is None:
        return None
    nz, ny, nx = work.grid_shape(config)
    return (kernel_work(kernel, config)[1] + work.encoder(nz, ny, nx, config["encoding"])
            + work.ADAM_OPS * params_count(config))
