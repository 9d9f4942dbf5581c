"""The inputs the benchmark makes from the seed and hands to both sides:
the model's weights (made on the device, in a few large draws of one
generator) and the fit's target snapshot.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import ngp as ref_ngp
from portbench.reference.train import unflatten


def _uniform(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n draws of U(-1, 1) in float32."""
    return torch.rand(n, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0


def make_params(config: dict, seed: int, device) -> dict:
    """The configuration's parameters in the program's layout, from `seed`:

    mlp: W1 [In, H], b1 [H], W2 [H, Out], b2 [Out], all U(-s, s) with s
    the configuration's init scale (the reference's init).
    ngp: the encoder's tables U(-s, s) (Instant-NGP's init, s = 1e-4),
    W1 [LF + 1, H] and W2 [H, 4] Glorot-uniform, zero biases."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if config["family"] == "mlp":
        d, s = config["dims"], config["init_scale"]
        shapes = {"W1": (d["In"], d["H"]), "b1": (d["H"],), "W2": (d["H"], d["Out"]), "b2": (d["Out"],)}
        flat = _uniform(gen, sum(math.prod(v) for v in shapes.values()), device) * s
        out, at = {}, 0
        for k, shape in shapes.items():
            out[k] = flat[at : at + math.prod(shape)].reshape(shape).clone()
            at += math.prod(shape)
        return out
    if config["family"] == "ngp":
        enc = config["encoding"]
        f, t = enc["features_per_level"], 1 << enc["log2_table_size"]
        res, dense = ref_ngp.resolutions(enc), ref_ngp.dense_levels(enc)
        shapes = {"tables/hash": (enc["num_levels"] - len(dense), t, f)}
        shapes.update({f"tables/dense/l{l}": (res[l] + 1,) * 3 + (f,) for l in dense})
        flat = _uniform(gen, sum(math.prod(v) for v in shapes.values()), device) * enc["init_scale"]
        pairs, at = [], 0
        for k, shape in shapes.items():
            pairs.append((k, flat[at : at + math.prod(shape)].reshape(shape).clone()))
            at += math.prod(shape)
        del flat
        lf, h, o = enc["num_levels"] * f, config["hidden"], config["out"]
        lim1, lim2 = math.sqrt(6.0 / (lf + 1 + h)), math.sqrt(6.0 / (h + o))
        head = _uniform(gen, (lf + 1) * h + h * o, device)
        pairs += [("W1", (head[: (lf + 1) * h] * lim1).reshape(lf + 1, h)),
                  ("b1", torch.zeros(h, device=device)),
                  ("W2", (head[(lf + 1) * h :] * lim2).reshape(h, o)),
                  ("b2", torch.zeros(o, device=device))]
        like = {"tables": {"hash": 0, "dense": {f"l{l}": 0 for l in dense}}, "W1": 0, "b1": 0, "W2": 0, "b2": 0}
        if not dense:
            like["tables"].pop("dense")
        return unflatten(pairs, like)
    raise ValueError(f"unknown family {config['family']!r}")


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

