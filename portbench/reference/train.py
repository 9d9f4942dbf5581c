"""The reference's training steps: the physics loss or the data loss of a
model, its gradient by autograd in blocks of z planes, and Adam.

Adam (Kingma and Ba), with torch.optim.Adam's constants and form:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
p -= lr / (1 - b1^k) * m / (sqrt(v) / sqrt(1 - b2^k) + eps).

`keep` (the share of the z planes whose cells the loss takes, the mean
over them alone) is 1 in the reference; the calibration's fault "half of
the batch left out" sets 0.5.
"""

from __future__ import annotations

import importlib
import math

import torch

from portbench.reference.grid import Grid, rows_with_halo, residuals_ext, row_blocks, slice_times
from portbench.reference.precision import Precision

BETAS, EPS = (0.9, 0.999), 1e-8
#: Device memory a block of the reference may hold (bytes).
BLOCK_BUDGET = 6e9


def flatten(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) pairs of a nested dict, sorted by path."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(flatten(v, f"{prefix}{k}/") if isinstance(v, dict) else [(f"{prefix}{k}", v)])
    return out


def unflatten(pairs, like):
    leaves = dict(pairs)

    def build(tree, prefix):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict) else leaves[f"{prefix}{k}"]
                for k, v in tree.items()}

    return build(like, "")


def family(cfg: dict):
    """reference/<family>.py of the configuration's model family, with its
    `field`, `fields` and `rows_per_block`."""
    return importlib.import_module(f"portbench.reference.{cfg['family']}")


def _rows(cfg: dict, g: Grid) -> int:
    return min(g.nz, family(cfg).rows_per_block(cfg, g, BLOCK_BUDGET))


def _kept_planes(g: Grid, keep: float) -> int:
    return max(1, int(round(g.nz * keep)))


def physics_loss_and_grad(cfg: dict, params: dict, g: Grid, weights: dict, t: float, prec: Precision,
                          keep: float = 1.0):
    """(loss, grads as (path, tensor) pairs) of the physics loss at time t."""
    fam = family(cfg)
    pairs = flatten(params)
    leaves = [p for _, p in pairs]
    ts = slice_times(t, g.dt)
    nz_kept = _kept_planes(g, keep)
    inv_n = 1.0 / (nz_kept * g.ny * g.nx)
    total = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    grads = [torch.zeros_like(p) for p in leaves]
    for z0, z1 in row_blocks(nz_kept, _rows(cfg, g)):
        with torch.enable_grad():
            sigma, u = fam.fields(cfg, params, g, rows_with_halo(g.nz, z0, z1, leaves[0].device), ts, prec)
            rs, ru = residuals_ext(g, sigma, u)
            part = (weights["w_sigma"] * torch.sum(rs * rs) + weights["w_u"] * torch.sum(ru * ru)) * inv_n
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
        total += part.detach().double()
        for acc, gr in zip(grads, gs):
            if gr is not None:
                acc += gr
    return total, [(path, gr) for (path, _), gr in zip(pairs, grads)]


def data_loss_and_grad(cfg: dict, params: dict, g: Grid, weights: dict, target: dict, prec: Precision,
                       keep: float = 1.0):
    """(loss, grads) of the data loss against target {"sigma" [nz, ny, nx],
    "u" [3, nz, ny, nx], "t"}: w_sigma mean(ds^2) + w_u mean(|du|^2)."""
    fam = family(cfg)
    pairs = flatten(params)
    leaves = [p for _, p in pairs]
    nz_kept = _kept_planes(g, keep)
    inv_n = 1.0 / (nz_kept * g.ny * g.nx)
    total = torch.zeros((), dtype=torch.float64, device=leaves[0].device)
    grads = [torch.zeros_like(p) for p in leaves]
    for z0, z1 in row_blocks(nz_kept, _rows(cfg, g)):
        rows = torch.arange(z0, z1, device=leaves[0].device)
        with torch.enable_grad():
            y = fam.field(cfg, params, g, rows, target["t"], prec)
            ds = y[..., 0] - target["sigma"][z0:z1].to(y.dtype)
            du = torch.movedim(y[..., 1:4], -1, 0) - target["u"][:, z0:z1].to(y.dtype)
            part = (weights["w_sigma"] * torch.sum(ds * ds) + weights["w_u"] * torch.sum(du * du)) * inv_n
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
        total += part.detach().double()
        for acc, gr in zip(grads, gs):
            if gr is not None:
                acc += gr
    return total, [(path, gr) for (path, _), gr in zip(pairs, grads)]


def trajectory(cfg: dict, params0: dict, g: Grid, weights: dict, lr: float, steps: int, prec: Precision,
               loss_and_grad) -> dict:
    """`steps` Adam steps from params0. loss_and_grad(params, k) -> (loss,
    grads) of step k. Returns the losses of the steps (each before its
    update), the first gradient, and each leaf's change after the first
    step and after all of them, all as float64 (path, tensor) pairs on the
    params' device."""
    params = {}
    pairs0 = [(path, p.detach().to(prec.dtype)) for path, p in flatten(params0)]
    leaves = [p.clone().requires_grad_() for _, p in pairs0]
    params = unflatten([(path, p) for (path, _), p in zip(pairs0, leaves)], params0)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    losses, grad1, change1 = [], None, None
    for k in range(1, steps + 1):
        loss, grads = loss_and_grad(params, k - 1)
        losses.append(float(loss))
        if grad1 is None:
            grad1 = [(path, gr.double()) for path, gr in grads]
        c1, c2 = 1 - BETAS[0] ** k, 1 - BETAS[1] ** k
        with torch.no_grad():
            for p, mi, vi, (_, gr) in zip(leaves, m, v, grads):
                mi.mul_(BETAS[0]).add_(gr, alpha=1 - BETAS[0])
                vi.mul_(BETAS[1]).addcmul_(gr, gr, value=1 - BETAS[1])
                p.addcdiv_(mi, vi.sqrt() / math.sqrt(c2) + EPS, value=-lr / c1)
        if change1 is None:
            change1 = [(path, (p.detach() - p0).double()) for (path, p0), p in zip(pairs0, leaves)]
    change = [(path, (p.detach() - p0).double()) for (path, p0), p in zip(pairs0, leaves)]
    return {"losses": losses, "grad1": grad1, "change": change, "change1": change1}


def field_blocks(cfg: dict, params: dict, g: Grid, t: float, prec: Precision):
    """Yields (z0, z1, field [z1 - z0, ny, nx, 4]) over the grid at time t."""
    fam = family(cfg)
    dev = next(iter(p for _, p in flatten(params))).device
    for z0, z1 in row_blocks(g.nz, _rows(cfg, g)):
        with torch.no_grad():  # not around the yield: grad mode would leak to the caller
            block = fam.field(cfg, params, g, torch.arange(z0, z1, device=dev), t, prec)
        yield z0, z1, block


def cast(params: dict, prec: Precision, grad: bool = False) -> dict:
    """A copy of params in prec's dtype (leaves that require grad)."""
    return unflatten([(path, p.detach().to(prec.dtype).clone().requires_grad_(grad)) for path, p in flatten(params)],
                     params)
