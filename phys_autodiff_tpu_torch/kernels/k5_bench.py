"""K5 in every tier on one card, for holding two trees against each other.

    python -m phys_autodiff_tpu_torch.kernels.k5_bench --save PATH [--label NAME]
    python -m phys_autodiff_tpu_torch.kernels.k5_bench --compare PATH_A PATH_B

--save runs this tree's K5 (kernels/mega_ngp.head_loss_and_grad) in the
tiers "f32", "bf16" and "f32_fastbwd" on inputs drawn with numpy from fixed
seeds (not through the encoder, so that two trees get the same bits): the
NGP flagship's shapes (128x96x96, LF = 16, H = 64), two edges of the head
core (24x13x5 upwind clamp LF = 15, H = 65; 33x9x2 upwind periodic LF =
17, H = 63) and the f32 shard-local build at nz_local = 24. It saves every
output to PATH (torch.save) and prints, per tier at the flagship, the
kernel's CUDA-event median of 20 calls, its device time from a
torch.profiler trace split by launch, the encoder's forward and pull-back
and one training step (make_ngp_train_step(precision=tier,
backward="mega"), NGPFieldConfig(), seed 777), with the card's name and
power limit. --compare prints whether the f32 outputs of two saves are
equal to the bit, the largest difference of every other output, and their
times side by side.

It runs in a `git archive` of another commit too (copy this file into its
phys_autodiff_tpu_torch/kernels/ and run it from that tree's root, each
tree in its own process): parent, change, change, parent in one chip call
compares two trees on one card. Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import subprocess

import numpy as np

FLAGSHIP = ((128, 96, 96), True, "central", 16, 64)
EDGES = (((24, 13, 5), False, "upwind", 15, 65), ((33, 9, 2), True, "upwind", 17, 63))
TIERS = ("f32", "bf16", "f32_fastbwd")


def _inputs(dev, g, lf, h, seed, t=0.25):
    """enc N(0, 1), Glorot W1 and W2, biases N(0, 0.3), the slice times."""
    import torch

    rng = np.random.default_rng(seed)

    def mk(*shape, scale=1.0):
        return torch.tensor((rng.standard_normal(shape) * scale).astype(np.float32), device=dev)

    enc = mk(g.nz, lf, g.ny, g.nx)
    w1 = mk(lf + 1, h, scale=math.sqrt(2.0 / (lf + 1 + h)))
    w2 = mk(h, 4, scale=math.sqrt(2.0 / (h + 4)))
    b1, b2 = mk(h, scale=0.3), mk(4, scale=0.3)
    ts = torch.tensor([t - g.dt, t, t + g.dt], dtype=torch.float32, device=dev)
    return enc, w1, b1, w2, b2, ts


def _grid(dims, periodic, scheme):
    from phys_autodiff_tpu_torch import GridSpec

    return GridSpec(*dims, hx=0.05, hy=0.05, hz=0.05, dt=1e-3, periodic=periodic, scheme=scheme)


def _flat(loss, grads):
    return [loss.detach().cpu()] + [x.detach().cpu() for x in grads if x is not None]


def digest(xs) -> str:
    """The first 16 hex digits of the sha256 of the tensors' float32 bytes
    in order: two runs' outputs are equal to the bit where their digests
    are (chip_smoke.py phase 3 holds f32 K5's to a recorded one)."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def f32_outputs(dev):
    """f32 K5's outputs at the flagship case and at its shard-local build
    (the rows 24 .. 47): {name: [loss or partials, gradients...]}."""
    from phys_autodiff_tpu_torch import PhysWeights
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels.mega_bwd import halo_rows

    dims, periodic, scheme, lf, h = FLAGSHIP
    g = _grid(dims, periodic, scheme)
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    args = _inputs(dev, g, lf, h, 1000 * lf + h)
    enc_s = args[0][halo_rows(g, 24, 24, dev)].contiguous()
    return {"f32 case 0": _flat(*k5.head_loss_and_grad(g, w, *args, "f32")),
            "f32 shard 24": _flat(*k5.head_loss_and_grad_shard(g, w, enc_s, *args[1:], 24, 24))}


def save(path: str, label: str) -> None:
    import torch

    from phys_autodiff_tpu_torch import PhysWeights
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.models import encoders, ngp
    from phys_autodiff_tpu_torch.train.loop import TrainConfig, make_ngp_train_step
    from phys_autodiff_tpu_torch.utils import tree
    from phys_autodiff_tpu_torch.utils.timing import cuda_time_ms, device_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("k5_bench needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    w = PhysWeights(w_sigma=1.3, w_u=0.7)
    out = {"label": label, "card": smi, "outputs": {}, "times": {}}
    for k, (dims, periodic, scheme, lf, h) in enumerate((FLAGSHIP, *EDGES)):
        g = _grid(dims, periodic, scheme)
        args = _inputs(dev, g, lf, h, 1000 * lf + h)
        for tier in TIERS:
            out["outputs"][f"{tier} case {k}"] = _flat(*k5.head_loss_and_grad(g, w, *args, tier))
        if k == 0:  # the f32 shard-local build: the rows 24 .. 47 of the flagship
            from phys_autodiff_tpu_torch.kernels.mega_bwd import halo_rows

            enc_s = args[0][halo_rows(g, 24, 24, dev)].contiguous()
            parts, grads = k5.head_loss_and_grad_shard(g, w, enc_s, *args[1:], 24, 24)
            out["outputs"]["f32 shard 24"] = _flat(parts, grads)
            for tier in TIERS:
                def call(tier=tier):
                    return k5.head_loss_and_grad(g, w, *args, tier)

                split = device_time_ms(call)
                out["times"][f"K5 {tier}"] = (cuda_time_ms(call), sum(split.values()), split)
        torch.cuda.synchronize()
    # the training step and the encoder on the main path's own inputs
    g = _grid(*FLAGSHIP[:3])
    ncfg = ngp.NGPFieldConfig()
    p0 = ngp.init_ngp_params(ncfg, seed=777, device=dev)
    leaves = [x.detach().requires_grad_() for x in tree.leaves(p0["tables"])]
    tables = tree.unflatten(p0["tables"], leaves)
    ct = torch.ones((g.nz, ncfg.encoding.out_dim, g.ny, g.nx), device=dev)

    def encoder():
        return torch.autograd.grad(encoders.encode_grid_zcf(ncfg.encoding, tables, g), leaves, ct)

    out["times"]["encoder fwd + pull-back"] = (cuda_time_ms(encoder), sum(device_time_ms(encoder).values()), {})
    for tier in TIERS:
        step, state = make_ngp_train_step(g, PhysWeights(), ncfg, TrainConfig(learning_rate=1e-3, seed=777, t=0.25),
                                          p0, tier, backward="mega")

        def one(step=step, state=state):
            return step(state)

        out["times"][f"ngp train step {tier}"] = (cuda_time_ms(one), sum(device_time_ms(one).values()), {})
    torch.save(out, path)
    print(f"k5_bench {label}: card {smi}")
    for name in ("f32 case 0", "f32 shard 24"):
        print(f"k5_bench {label}: digest of the {name} outputs: {digest(out['outputs'][name])}")
    for name, (ev, devt, split) in out["times"].items():
        parts = ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(split.items()))
        print(f"k5_bench {label}: {name}: {ev:.4f} ms (events), {devt:.4f} ms on the device" + (f" ({parts})" if parts else ""))


def compare(path_a: str, path_b: str) -> None:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    print(f"k5_bench compare {a['label']} ({a['card']}) vs {b['label']} ({b['card']})")
    for key in a["outputs"]:
        xs, ys = a["outputs"][key], b["outputs"][key]
        same = len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))
        diff = max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))
        print(f"k5_bench compare {key}: bitwise equal {same}, max abs difference {diff:.3e}")
    for name in a["times"]:
        (ea, da, _), (eb, db, _) = a["times"][name], b["times"][name]
        print(f"k5_bench compare {name}: events {ea:.4f} -> {eb:.4f} ms, device {da:.4f} -> {db:.4f} ms")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", metavar="PATH")
    ap.add_argument("--label", default="tree")
    ap.add_argument("--compare", nargs=2, metavar="PATH")
    args = ap.parse_args(argv)
    if args.save:
        save(args.save, args.label)
    if args.compare:
        compare(*args.compare)


if __name__ == "__main__":
    main()
