"""The inputs the benchmark makes from the seed and hands to both sides:
the model's weights (made on the device, in a few large draws of one
generator) and the fit's target snapshot.
"""

from __future__ import annotations

import math

import torch

from portbench.core import specs


def uniform(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n draws of U(-1, 1) in float32."""
    return torch.rand(n, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0


def draw(gen: torch.Generator, shapes: dict, scale: float, device) -> list[tuple[str, torch.Tensor]]:
    """(name, tensor) of each of `shapes`, in order, cut from one draw of
    U(-scale, scale)."""
    flat = uniform(gen, sum(math.prod(v) for v in shapes.values()), device) * scale
    out, at = [], 0
    for k, shape in shapes.items():
        out.append((k, flat[at : at + math.prod(shape)].reshape(shape).clone()))
        at += math.prod(shape)
    return out


def make_params(config: dict, seed: int, device) -> dict:
    """The configuration's parameters in the program's layout, from `seed`:
    its family's `make_params`."""
    return specs.family(config["family"]).make_params(config, seed, device)


def trig_mix(grid: dict, device) -> dict:
    """The fit flagship's target: a multi-octave trig mix (the multi-scale
    content hash encodings exist for), float32 sigma [nz, ny, nx] and u
    [3, nz, ny, nx], x = i / nx per axis."""
    z = torch.arange(grid["nz"], device=device, dtype=torch.float64)[:, None, None] / grid["nz"]
    y = torch.arange(grid["ny"], device=device, dtype=torch.float64)[None, :, None] / grid["ny"]
    x = torch.arange(grid["nx"], device=device, dtype=torch.float64)[None, None, :] / grid["nx"]
    tp = 2 * math.pi
    sigma = (0.5 * torch.sin(tp * x) * torch.cos(tp * y) + 0.25 * torch.sin(3 * tp * (x + z))
             + 0.125 * torch.cos(7 * tp * y) * torch.sin(5 * tp * z))
    shape = (grid["nz"], grid["ny"], grid["nx"])
    u = torch.stack([
        (0.4 * torch.cos(tp * z) + 0.1 * torch.sin(4 * tp * y)).expand(shape),
        (0.3 * torch.sin(tp * x) * torch.cos(3 * tp * z)).expand(shape),
        (0.2 * torch.cos(2 * tp * (x + y))).expand(shape),
    ])
    return {"sigma": sigma.expand(shape).float().contiguous(), "u": u.float().contiguous()}

