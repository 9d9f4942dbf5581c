"""The K-Planes field (configurations with "family": "kplanes"): six planes
over (x, y, z, t) at several scales, multiplied within a scale, and a decode
head with no time input; the port's NGPFieldConfig over its KPlanesConfig,
the weights, the training step (the encoder pair, K5 on the three slices'
encodings, the pull-back) and the least work. Its plain reference is
reference/kplanes.py.
"""

from __future__ import annotations

import math

import torch

from portbench.core import inputs, work
from portbench.reference.kplanes import PLANES, plane_shape
from portbench.reference.train import unflatten


def model_config(config: dict):
    from phys_autodiff_tpu_torch.models.kplanes import KPlanesConfig
    from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig

    enc = dict(config["encoding"], multipliers=tuple(config["encoding"]["multipliers"]))
    return NGPFieldConfig(encoding=KPlanesConfig(**enc), hidden=config["hidden"], out=config["out"])


def _lf(config: dict) -> int:
    enc = config["encoding"]
    return len(enc["multipliers"]) * enc["features"]


#: The published init of the planes without t: U(0.1, 0.5).
INIT_LOW, INIT_HIGH = 0.1, 0.5


def make_params(config: dict, seed: int, device) -> dict:
    """The planes without t U(0.1, 0.5) (one draw, scale-major, xy, xz,
    yz), the planes with t 1 (the published code's init); W1 [LF, H] and
    W2 [H, 4] Glorot-uniform (one draw), zero biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    enc = config["encoding"]
    lo, hi = INIT_LOW, INIT_HIGH
    nsc = len(enc["multipliers"])
    spatial = [(l, p) for l in range(nsc) for p in PLANES if "t" not in p]
    shapes = {f"tables/s{l}/{p}": plane_shape(enc, l, p) for l, p in spatial}
    flat = inputs.uniform(gen, sum(math.prod(s) for s in shapes.values()), device) * (0.5 * (hi - lo)) + 0.5 * (hi + lo)
    pairs, at = [], 0
    for k, shape in shapes.items():
        n = math.prod(shape)
        pairs.append((k, flat[at : at + n].reshape(shape).clone()))
        at += n
    del flat
    pairs += [(f"tables/s{l}/{p}", torch.ones(plane_shape(enc, l, p), device=device))
              for l in range(nsc) for p in PLANES if "t" in p]
    lf, h, o = _lf(config), config["hidden"], config["out"]
    lim1, lim2 = math.sqrt(6.0 / (lf + h)), math.sqrt(6.0 / (h + o))
    head = inputs.uniform(gen, lf * h + h * o, device)
    pairs += [("W1", (head[: lf * h] * lim1).reshape(lf, h)),
              ("b1", torch.zeros(h, device=device)),
              ("W2", (head[lf * h :] * lim2).reshape(h, o)),
              ("b2", torch.zeros(o, device=device))]
    like = {"tables": {f"s{l}": {p: 0 for p in PLANES} for l in range(nsc)}, "W1": 0, "b1": 0, "W2": 0, "b2": 0}
    return unflatten(pairs, like)


def train_step(config: dict, traffic: dict, g, w, model, cfg, params0: dict):
    """(step, state) of `train.loop.make_ngp_train_step` with the traffic's
    engine as its backward ("mega": the encoder, one call of K5 on the three
    slices' encodings, the pull-back)."""
    from phys_autodiff_tpu_torch.train.loop import make_ngp_train_step

    return make_ngp_train_step(g, w, model, cfg, params0, precision=config["precision"], backward=traffic["engine"])


def params_count(config: dict) -> int:
    enc = config["encoding"]
    planes = sum(math.prod(plane_shape(enc, l, p)) for l in range(len(enc["multipliers"])) for p in PLANES)
    lf, hn = _lf(config), config["hidden"]
    return planes + lf * hn + hn + hn * config["out"] + config["out"]


#: Slices a step (t - dt, t, t + dt), each with its own encoding.
SLICES = 3


def kplanes_work(config: dict) -> tuple[float, float]:
    """The encoder pair and the per-slice K5 together (csrc/kplanes_encode.cu,
    csrc/mega_ngp.cu pat_mega_ngp_kplanes), whatever the split between
    them: the planes and the head read once and their gradients written
    once; per cell the head 18 LF H + 71 H (the three slices' forward 6 LF
    H and 30 H, dW1 and dEnc 6 LF H each, the backward's 41 H), the
    residual and its adjoint, and the encoding's products, 2 multiplies a
    feature and slice forward and 4 back."""
    nz, ny, nx = work.grid_shape(config)
    n = nz * ny * nx
    lf, hn = _lf(config), config["hidden"]
    ops = (18 * lf * hn + 71 * hn + work.RES_OPS + work.ADJ_OPS + 6 * lf * SLICES) * n
    return 4 * 2 * params_count(config), ops


def kernel_work(kernel: str, config: dict) -> tuple[float, float] | None:
    return kplanes_work(config) if kernel == "kplanes" else None


def unit_flops(loop: str, config: dict) -> float | None:
    """A training step: the encoder pair and K5 (kplanes_work), and Adam."""
    if loop != "train":
        return None
    return kplanes_work(config)[1] + work.ADAM_OPS * params_count(config)
