"""The bf16-tier kernels and every kernel that shares their sources, on one
card, for holding two trees against each other.

    python -m phys_autodiff_tpu_torch.kernels.tier_bench --save PATH [--label NAME]
    python -m phys_autodiff_tpu_torch.kernels.tier_bench --compare PATH_A PATH_B

--save runs this tree's kernels on inputs drawn with numpy from fixed seeds
(not through the encoder, so that two trees get the same bits) and saves
every output to PATH (torch.save):
  K4 (kernels/mega_bwd.table_loss_and_grad) in "f32" and "bf16" on the
    folded tables of the H = 128 MLP at 128x96x96 (seed 777, t = 0.25),
    two edges (24x13x5 upwind clamp H = 128, 33x9x2 upwind periodic H = 63)
    and the shard-local build at nz_local 24 and 48;
  K7 (kernels/fit.ngp_fit_head_loss_and_grad) in "f32" and "bf16" at the
    NGP flagship's shapes (LF = 16, H = 64), two edges of the head core and
    the shards' rows 24 .. 47 and 48 .. 95;
  K5 (kernels/mega_ngp.head_loss_and_grad) in every tier at the flagship
    and the same edges, and its f32 shard-local build at nz_local 24;
  K6 (kernels/fit.fit_table_loss_and_grad) in "bf16" at the MLP flagship
    (H = 128, seed 777, the target N(0, 1)), the two MLP edges and the
    shards' rows (fit_table_loss_and_grad_shard, nz_local 24 and 48);
  K2 bf16 / bf16x3 (the packed fields), K3 bf16 (the loss), K4 bf16 and
    K6 f32 at the MLP flagship, f32 K7 and K7 bf16 at the NGP flagship.
It prints the digest of each case's outputs (`digest`: chip_smoke.py holds
the kernels that a redesign leaves alone to recorded ones) and, per
timed kernel, the CUDA-event median of 20 calls and the device time from a
torch.profiler trace split by launch: K4 and K7 in both tiers at the
flagship and on the shards, K5 in every tier, K6 bf16 at the flagship and
on the shards, K3 bf16, K2 bf16 / bf16x3 (S = 3, packed; S = 1,
grid_infer_fused), K2 f32, K1 and K3 f32 (the f32 kernels of those
sources), the bf16 mega
forward loss (mega_loss_pipeline) beside the staged bf16 one (K2 bf16 ->
K1, fused_loss_pipeline), the bf16 MLP training step (make_train_step,
use_fused, precision "bf16"), the bf16 MLP fit step (fit_field's
make_fit_step, engine "mega", H = 128) and the bf16 NGP fit step (engine
"mega", the fast encode), with the card's name and power limit, and K4
bf16's fields and adjoint passes as rows of their own (SPLIT_ROWS). A
profiler turn that kept fewer records of a kernel than its launches is
flagged and repeated once (utils/timing.device_time_turn). --compare
prints whether each case's outputs of two saves are equal to the bit, their
largest difference, and the times side by side, and fails if a case outside
REDESIGNED is not equal to the bit.

It runs in a `git archive` of another commit too (copy this file and
utils/timing.py into its phys_autodiff_tpu_torch/ and run it from that
tree's root, each
tree in its own process): parent, change, change, parent in one chip call
compares two trees on one card. The saves hold every flagship output, so
keep them under build/. Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import subprocess

import numpy as np

FLAGSHIP = ((128, 96, 96), True, "central", 16, 64)
EDGES = (((24, 13, 5), False, "upwind", 15, 65), ((33, 9, 2), True, "upwind", 17, 63))
MLP_EDGES = (((24, 13, 5), False, "upwind", 128), ((33, 9, 2), True, "upwind", 63))
K5_TIERS = ("f32", "bf16", "f32_fastbwd")
SHARDS = (24, 48)  # nz_local of the 4- and 2-way splits: rows nz_local .. 2 nz_local - 1
#: The cases whose outputs a redesign may change: --compare holds every
#: other case to the bit. K2 bf16 / bf16x3's redesign keeps every output.
REDESIGNED = ()


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


def _target(dev, g, seed):
    """A packed target [nz, 4, ny*nx], N(0, 1)."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((g.nz, 4, g.ny * g.nx)).astype(np.float32), device=dev)


def _grid(dims, periodic, scheme):
    from phys_autodiff_tpu_torch import GridSpec

    return GridSpec(*dims, hx=0.05, hy=0.05, hz=0.05, dt=1e-3, periodic=periodic, scheme=scheme)


def _mlp(dev, h, seed):
    from phys_autodiff_tpu_torch import MLPDims, MLPGridConfig
    from phys_autodiff_tpu_torch.models import mlp

    cfg = MLPGridConfig(dims=MLPDims(H=h))
    return cfg, mlp.init_params(cfg.dims, seed=seed, device=dev)


def _flat(loss, grads):
    return [loss.detach().cpu()] + [x.detach().cpu() for x in grads if x is not None]


def digest(xs) -> str:
    """The first 16 hex digits of the sha256 of the tensors' float32 bytes
    in order: two runs' outputs are equal to the bit where their digests
    are."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().float().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _w():
    from phys_autodiff_tpu_torch import PhysWeights

    return PhysWeights(w_sigma=1.3, w_u=0.7)


def f32_k5_outputs(dev):
    """f32 K5's outputs at the flagship case and at its shard-local build
    (the rows 24 .. 47): {name: [loss or partials, gradients...]}."""
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels.mega_bwd import halo_rows

    dims, periodic, scheme, lf, h = FLAGSHIP
    g = _grid(dims, periodic, scheme)
    args = _inputs(dev, g, lf, h, 1000 * lf + h)
    enc_s = args[0][halo_rows(g, 24, 24, dev)].contiguous()
    return {"K5 f32 case 0": _flat(*k5.head_loss_and_grad(g, _w(), *args, "f32")),
            "K5 f32 shard 24": _flat(*k5.head_loss_and_grad_shard(g, _w(), enc_s, *args[1:], 24, 24))}


def held_outputs(dev):
    """The outputs at the flagships of the kernels whose outputs K6 bf16's
    and K3 bf16's redesign leaves alone, {name: [tensors]}: K4 bf16's loss
    and its every output, f32 K4, K2 bf16 / bf16x3, K3 bf16, f32 K6, K5
    bf16 and f32_fastbwd (f32 K5's: f32_k5_outputs), f32 K7 and K7 bf16."""
    import torch

    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega as k3
    from phys_autodiff_tpu_torch.kernels import mega_bwd as k4
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.models.fields import slice_times

    out = {}
    g = _grid(*FLAGSHIP[:3])
    t = torch.full((), 0.25, device=dev)
    cfg, p = _mlp(dev, 128, 777)
    tabs = kmlp.fold_tables(g, cfg, p, slice_times(t, g.dt))
    k4_bf16 = k4.table_loss_and_grad(g, _w(), *tabs, "bf16")
    out["K4 bf16 loss"] = [k4_bf16[0].cpu()]
    out["K4 bf16"] = _flat(*k4_bf16)
    out["K4 f32"] = _flat(*k4.table_loss_and_grad(g, _w(), *tabs, "f32"))
    for tier in ("bf16", "bf16x3"):
        out[f"K2 {tier}"] = [kmlp.generate_fields_fused_packed(g, cfg, p, t, tier).cpu()]
    out["K3 bf16"] = [k3._mega_partials(g, _w(), *tabs, "bf16")[1].cpu()]
    tabs1 = kmlp.fold_tables(g, cfg, p, t.reshape(1))
    tgt = _target(dev, g, 5)
    out["K6 f32"] = _flat(*kfit.fit_table_loss_and_grad(g, _w(), *tabs1, tgt, "f32"))
    lf, h = FLAGSHIP[3:]
    args = _inputs(dev, g, lf, h, 1000 * lf + h)
    for tier in ("bf16", "f32_fastbwd"):  # f32: f32_k5_outputs
        out[f"K5 {tier}"] = _flat(*k5.head_loss_and_grad(g, _w(), *args, tier))
    for tier in ("f32", "bf16"):
        out[f"K7 {tier}"] = _flat(*kfit.ngp_fit_head_loss_and_grad(g, _w(), *args[:5], t, tgt, tier))
    return out


def time_case(name, call, times, log=print) -> None:
    """times[name] = (the CUDA-event median of 20 calls, the device time a
    call, {kernel: device ms a call}) from a profiler turn of 10 calls
    (utils/timing.device_time_turn: a turn that lost records is flagged
    and repeated once; a flag left after the repeat is logged again)."""
    from phys_autodiff_tpu_torch.utils import timing

    kt, bad = timing.device_time_turn(call, what=f"tier_bench {name}", log=log)
    split = {k: v.call_ms for k, v in kt.items()}
    times[name] = (timing.cuda_time_ms(call), sum(split.values()), split)
    if bad:
        log(f"tier_bench {name}: DROPPED RECORDS after the repeat: {', '.join(k[:48] for k in bad)}")


#: Rows of their own cut from a timed case's split: (row, case, the
#: kernel-name fragment whose device time the row is).
SPLIT_ROWS = (("K4 bf16 fields pass", "K4 bf16", "k_bwd_fields"),
              ("K4 bf16 adjoint pass", "K4 bf16", "k_bwd_adjoint"))


def split_rows(times) -> dict[str, float]:
    """The device ms a call of each SPLIT_ROWS row that `times` holds."""
    out = {}
    for row, case, part in SPLIT_ROWS:
        if case in times:
            out[row] = sum(v for k, v in times[case][2].items() if part in k)
    return out


def save(path: str, label: str) -> None:
    import torch

    from phys_autodiff_tpu_torch import PhysWeights
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega_bwd as k4
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.models import ngp
    from phys_autodiff_tpu_torch.models.fields import slice_times
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.train.loop import TrainConfig, make_train_step, state_from_params

    if not torch.cuda.is_available():
        raise SystemExit("tier_bench needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    w = _w()
    out = {"label": label, "card": smi, "outputs": {}, "times": {}}
    outs, times = out["outputs"], out["times"]

    def timed(name, call):
        time_case(name, call, times)

    t = torch.full((), 0.25, device=dev)
    # K4: the flagship, the edges, the shards
    for k, (dims, periodic, scheme, h) in enumerate((FLAGSHIP[:3] + (128,), *MLP_EDGES)):
        g = _grid(dims, periodic, scheme)
        cfg, p = _mlp(dev, h, 777 if k == 0 else 5)
        tabs = kmlp.fold_tables(g, cfg, p, slice_times(t, g.dt))
        for tier in ("f32", "bf16"):
            outs[f"K4 {tier} case {k}"] = _flat(*k4.table_loss_and_grad(g, w, *tabs, tier))
            if k == 0:
                timed(f"K4 {tier}", lambda tier=tier: k4.table_loss_and_grad(g, w, *tabs, tier))
                for nzl in SHARDS:
                    def shard(tier=tier, nzl=nzl):
                        return k4.table_loss_and_grad_shard(g, w, *tabs, nzl, nzl, tier)

                    outs[f"K4 {tier} shard {nzl}"] = _flat(*shard())
                    timed(f"K4 {tier} shard {nzl}", shard)
    # K6 bf16: the flagship, the edges, the shards; K3 bf16, K2 bf16 / bf16x3
    # and the two bf16 forward losses at the flagship
    from phys_autodiff_tpu_torch.kernels import mega as k3

    for k, (dims, periodic, scheme, h) in enumerate((FLAGSHIP[:3] + (128,), *MLP_EDGES)):
        g = _grid(dims, periodic, scheme)
        cfg, p = _mlp(dev, h, 777 if k == 0 else 5)
        tabs1 = kmlp.fold_tables(g, cfg, p, t.reshape(1))
        tgt = _target(dev, g, 5 + k)
        outs[f"K6 bf16 case {k}"] = _flat(*kfit.fit_table_loss_and_grad(g, w, *tabs1, tgt, "bf16"))
        if k == 0:
            timed("K6 bf16", lambda: kfit.fit_table_loss_and_grad(g, w, *tabs1, tgt, "bf16"))
            for nzl in SHARDS:
                t_s = tgt[nzl:2 * nzl].contiguous()

                def shard(nzl=nzl, t_s=t_s):
                    return kfit.fit_table_loss_and_grad_shard(g, w, *tabs1, t_s, nzl, nzl, "bf16")

                outs[f"K6 bf16 shard {nzl}"] = _flat(*shard())
                timed(f"K6 bf16 shard {nzl}", shard)
            tabs3 = kmlp.fold_tables(g, cfg, p, slice_times(t, g.dt))
            timed("K3 bf16", lambda: k3._mega_partials(g, w, *tabs3, "bf16"))
            for tier in ("bf16", "bf16x3"):
                timed(f"K2 {tier}", lambda tier=tier: kmlp.generate_fields_fused_packed(g, cfg, p, t, tier))
                timed(f"K2 {tier} S=1", lambda tier=tier: kmlp.grid_infer_fused(g, cfg, p, 0.25, tier))
            timed("mega loss bf16", lambda: k3.mega_loss_pipeline(g, w, cfg, p, t, "bf16"))
            timed("fused loss bf16", lambda: kmlp.fused_loss_pipeline(g, w, cfg, p, t, "bf16"))
            # the f32 kernels beside them in the same sources: K2 f32, K1, K3 f32
            from phys_autodiff_tpu_torch.kernels import residuals as k1

            packed = kmlp.generate_fields_fused_packed(g, cfg, p, t)
            timed("K2 f32", lambda: kmlp.generate_fields_fused_packed(g, cfg, p, t))
            timed("K1", lambda: k1.residuals_fused_packed(g, packed))
            timed("K3 f32", lambda: k3._mega_partials(g, w, *tabs3))
    # K7 and K5: the flagship and the edges; K7's shards, K5's f32 shard
    for k, (dims, periodic, scheme, lf, h) in enumerate((FLAGSHIP, *EDGES)):
        g = _grid(dims, periodic, scheme)
        args = _inputs(dev, g, lf, h, 1000 * lf + h)
        tgt = _target(dev, g, 7 + k)
        for tier in ("f32", "bf16"):
            outs[f"K7 {tier} case {k}"] = _flat(*kfit.ngp_fit_head_loss_and_grad(g, w, *args[:5], t, tgt, tier))
            if k == 0:
                timed(f"K7 {tier}", lambda tier=tier: kfit.ngp_fit_head_loss_and_grad(g, w, *args[:5], t, tgt, tier))
                for nzl in SHARDS:
                    e_s, t_s = args[0][nzl:2 * nzl].contiguous(), tgt[nzl:2 * nzl].contiguous()

                    def shard(tier=tier, nzl=nzl, e_s=e_s, t_s=t_s):
                        return kfit.ngp_fit_head_loss_and_grad_shard(g, w, e_s, *args[1:5], t, t_s, nzl, nzl, tier)

                    outs[f"K7 {tier} shard {nzl}"] = _flat(*shard())
                    timed(f"K7 {tier} shard {nzl}", shard)
        for tier in K5_TIERS:
            outs[f"K5 {tier} case {k}"] = _flat(*k5.head_loss_and_grad(g, w, *args, tier))
            if k == 0:
                timed(f"K5 {tier}", lambda tier=tier: k5.head_loss_and_grad(g, w, *args, tier))
        del args, tgt
        torch.cuda.empty_cache()
    outs.update(f32_k5_outputs(dev))
    held = held_outputs(dev)
    outs.update({f"held {k}": v for k, v in held.items()})
    torch.cuda.empty_cache()
    # the bf16 MLP training step and the bf16 NGP fit step
    g = _grid(*FLAGSHIP[:3])
    cfg, p = _mlp(dev, 128, 777)
    scfg = TrainConfig(learning_rate=1e-3, seed=777, t=0.25, use_fused=True, precision="bf16")
    step, state = make_train_step(g, PhysWeights(), cfg, scfg), state_from_params(scfg, p)
    timed("train step mlp bf16", lambda: step(state))
    mtarget = ff.FitTarget(*(torch.tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32),
                                          device=dev) for seed, shape in ((12, g.shape), (13, (3,) + g.shape))), 0.25)
    mstep, mstate = ff.make_fit_step(g, cfg, [mtarget], TrainConfig(learning_rate=3e-3, precision="bf16"),
                                     params0=p, engine="mega")
    timed("fit step mlp bf16", lambda: mstep(mstate))  # K6 bf16
    ncfg = ngp.NGPFieldConfig()
    rng = np.random.default_rng(11)
    target = ff.FitTarget(torch.tensor(rng.standard_normal(g.shape).astype(np.float32), device=dev),
                          torch.tensor(rng.standard_normal((3,) + g.shape).astype(np.float32), device=dev), 0.25)
    fstep, fstate = ff.make_fit_step(g, ncfg, [target], TrainConfig(learning_rate=5e-3, precision="bf16"),
                                     params0=ngp.init_ngp_params(ncfg, seed=0, device=dev), engine="mega")
    timed("fit step ngp bf16", lambda: fstep(fstate))  # K7 bf16 on the fast encode
    torch.save(out, path)
    print(f"tier_bench {label}: card {smi}")
    for name, xs in held.items():
        print(f"tier_bench {label}: digest of the {name} outputs: {digest(xs)}")
    for name, xs in f32_k5_outputs(dev).items():
        print(f"tier_bench {label}: digest of the {name} outputs: {digest(xs)}")
    for name, (ev, devt, split) in times.items():
        parts = ", ".join(f"{k[:48]} {v:.4f}" for k, v in sorted(split.items()))
        print(f"tier_bench {label}: {name}: {ev:.4f} ms (events), {devt:.4f} ms on the device" +
              (f" ({parts})" if parts else ""))
    for row, ms in split_rows(times).items():
        print(f"tier_bench {label}: {row}: {ms:.4f} ms on the device")


def compare(path_a: str, path_b: str) -> None:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    print(f"tier_bench compare {a['label']} ({a['card']}) vs {b['label']} ({b['card']})")
    moved = []
    for key in a["outputs"]:
        if key not in b["outputs"]:
            print(f"tier_bench compare {key}: only in {a['label']}")
            continue
        xs, ys = a["outputs"][key], b["outputs"][key]
        same = len(xs) == len(ys) and all(torch.equal(x, y) for x, y in zip(xs, ys))
        diff = max(float((x.double() - y.double()).abs().max()) for x, y in zip(xs, ys))
        print(f"tier_bench compare {key}: bitwise equal {same}, max abs difference {diff:.3e}")
        if not same and not key.startswith(REDESIGNED):
            moved.append(key)
    for name in a["times"]:
        if name in b["times"]:
            (ea, da, _), (eb, db, _) = a["times"][name], b["times"][name]
            print(f"tier_bench compare {name}: events {ea:.4f} -> {eb:.4f} ms, device {da:.4f} -> {db:.4f} ms")
    rows_a, rows_b = split_rows(a["times"]), split_rows(b["times"])
    for row in rows_a.keys() & rows_b.keys():
        print(f"tier_bench compare {row}: device {rows_a[row]:.4f} -> {rows_b[row]:.4f} ms")
    if moved:
        raise SystemExit(f"tier_bench compare: outputs that must not move did: {', '.join(moved)}")


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
