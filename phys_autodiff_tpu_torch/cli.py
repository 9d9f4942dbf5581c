"""The port's command-line interface: `python -m phys_autodiff_tpu_torch`
(port of phys_autodiff_tpu/cli.py).

Every subcommand is a thin shell over the library (nothing here owns logic
beyond argument plumbing):

  info       torch's device, the port's version, the registered model families
  train      physics-residual training (train/loop) -> model checkpoint
  fit        supervised neural-field fitting to exported snapshots
             (train/fit_field) -> model checkpoint + PSNR report
  serve      evaluate a model checkpoint on its grid (npz / VTK out) or at
             arbitrary points (models/sample)
  simulate   incompressible-Euler smoke rollout (apps/euler) -> VTK series
  export     convert a field snapshot .npz to VTK

The arguments and the JSON line each command prints are the JAX CLI's, plus
`--device` (default "cuda") on the commands that place tensors: it is how a
caller asks for the CPU. Model checkpoints are models/modelio.py's
self-describing .npz files, which the two packages read both ways.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _add_grid_args(p: argparse.ArgumentParser, defaults=(64, 64, 32)) -> None:
    p.add_argument("--grid", type=str, default="x".join(map(str, defaults)), help="nx x ny x nz, e.g. 128x96x96")
    p.add_argument("--h", type=float, default=0.05, help="cell size (hx=hy=hz)")
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--clamp", action="store_true", help="clamped boundaries (default periodic)")
    p.add_argument("--scheme", choices=["central", "upwind"], default="central")


def _grid_from_args(args):
    from phys_autodiff_tpu_torch.utils.config import GridSpec

    nx, ny, nz = (int(v) for v in args.grid.lower().split("x"))
    return GridSpec(nx=nx, ny=ny, nz=nz, hx=args.h, hy=args.h, hz=args.h, dt=args.dt, periodic=not args.clamp,
                    scheme=args.scheme)


def _add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--family", choices=["mlp", "ngp", "fourier", "kplanes"], default="mlp")
    p.add_argument("--hidden", type=int, default=64, help="hidden width (MLP H / encoded-family head width)")
    p.add_argument("--levels", type=int, default=8, help="ngp: hash-encoding levels")
    p.add_argument("--max-res", type=int, default=128, help="ngp: finest encoding resolution")
    p.add_argument("--frequencies", type=int, default=6, help="fourier: octaves per axis")
    p.add_argument("--kp-base", type=int, default=64, help="kplanes: spatial resolution of the coarsest scale")
    p.add_argument("--kp-multipliers", type=str, default="1,2,4,8", help="kplanes: the scales' multipliers")
    p.add_argument("--kp-time-res", type=int, default=25, help="kplanes: time resolution (every scale)")
    p.add_argument("--kp-features", type=int, default=32, help="kplanes: features a plane and scale")
    p.add_argument("--seed", type=int, default=0)


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device of the params and fields (default cuda)")


def _model_cfg_from_args(args):
    from phys_autodiff_tpu_torch.utils.config import MLPDims, MLPGridConfig

    if args.family == "mlp":
        return MLPGridConfig(dims=MLPDims(H=args.hidden))
    from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig

    if args.family == "ngp":
        from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig

        enc = HashEncodingConfig(num_levels=args.levels, max_resolution=args.max_res, dense_oversubscribed=True)
    elif args.family == "kplanes":
        from phys_autodiff_tpu_torch.models.kplanes import KPlanesConfig

        enc = KPlanesConfig(base_resolution=args.kp_base,
                            multipliers=tuple(int(m) for m in args.kp_multipliers.split(",")),
                            time_resolution=args.kp_time_res, features=args.kp_features)
    else:
        from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig

        enc = FourierEncodingConfig(num_frequencies=args.frequencies)
    return NGPFieldConfig(encoding=enc, hidden=args.hidden)


def _add_opt_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", choices=["adam", "adamw", "sgd"], default="adam")
    p.add_argument("--grad-clip", type=float, default=0.0)
    p.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant")
    p.add_argument("--warmup-steps", type=int, default=0)


def _train_cfg_from_args(args, **over):
    from phys_autodiff_tpu_torch.train import TrainConfig

    kw = dict(steps=args.steps, learning_rate=args.lr, optimizer=args.optimizer, grad_clip=args.grad_clip,
              lr_schedule=args.lr_schedule, warmup_steps=args.warmup_steps, seed=args.seed)
    kw.update(over)
    return TrainConfig(**kw)


def cmd_info(args) -> int:
    import phys_autodiff_tpu_torch
    from phys_autodiff_tpu_torch.models import encoders

    on_card = torch.cuda.is_available()
    print(json.dumps({
        "version": getattr(phys_autodiff_tpu_torch, "__version__", "dev"),
        "backend": "cuda" if on_card else "cpu",
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())] if on_card else ["cpu"],
        "torch": torch.__version__,
        "model_families": ["mlp"] + [t.__name__ for t in encoders.registered_families()],
    }))
    return 0


def cmd_train(args) -> int:
    from phys_autodiff_tpu_torch.models import modelio
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.train import loop
    from phys_autodiff_tpu_torch.utils.config import PhysWeights

    g = _grid_from_args(args)
    mcfg = _model_cfg_from_args(args)
    cfg = _train_cfg_from_args(args, t=args.t)
    w = PhysWeights()
    if args.family == "mlp":
        state, history, _ = loop.fit_scan(g, w, mcfg, cfg, device=args.device)
        params = state.params
        losses = [l for _, l in history]
    else:
        params0 = ff.init_any(mcfg, seed=args.seed, device=args.device)
        step, state = loop.make_ngp_train_step(g, w, mcfg, cfg, params0, backward=args.backward)
        losses = []
        for i in range(cfg.steps):
            state, loss = step(state)
            if i % cfg.log_every == 0 or i == cfg.steps - 1:
                losses.append(float(loss))
                print(f"step {i} loss {float(loss):.6g}", file=sys.stderr)
        params = state.params
    modelio.save_model(args.out, g, mcfg, params)
    print(json.dumps({
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "drop": 1.0 - float(losses[-1]) / float(losses[0]),
        "checkpoint": args.out,
    }))
    return 0 if np.isfinite(np.float32(losses[-1])) else 1


def _load_target(path, device, t_override=None):
    from phys_autodiff_tpu_torch.train import fit_field as ff
    from phys_autodiff_tpu_torch.utils import export

    fields, meta = export.load_fields_npz(path)
    if "sigma" not in fields or "u" not in fields:
        raise SystemExit(f"{path} must carry 'sigma' [nz,ny,nx] and 'u' [3,nz,ny,nx] (has: {sorted(fields)})")
    t = meta.get("t", 0.25) if t_override is None else t_override
    return ff.target_from_arrays(fields["sigma"], fields["u"], t, device=device), meta


_GRID_KEYS = ("nx", "ny", "nz", "hx", "hy", "hz", "dt", "periodic", "scheme")


def cmd_fit(args) -> int:
    from phys_autodiff_tpu_torch.models import modelio
    from phys_autodiff_tpu_torch.train import fit_field as ff

    targets, meta = [], None
    for path in args.target:
        tgt, meta = _load_target(path, args.device)
        targets.append(tgt)
    g = modelio.grid_from_meta({k: meta[k] for k in _GRID_KEYS})
    mcfg = _model_cfg_from_args(args)
    cfg = _train_cfg_from_args(args)
    params, losses = ff.fit_field(g, mcfg, targets, cfg, phys_weight=args.phys_weight, engine=args.engine,
                                  device=args.device)
    modelio.save_model(args.out, g, mcfg, params)
    report = ff.fit_report(g, mcfg, params, targets)
    report.update(loss_first=float(losses[0]), loss_last=float(losses[-1]), checkpoint=args.out)
    print(json.dumps(report))
    return 0


def cmd_serve(args) -> int:
    from phys_autodiff_tpu_torch.models import modelio, sample
    from phys_autodiff_tpu_torch.utils import export

    g, mcfg, params = modelio.load_model(args.ckpt, device=args.device)
    with torch.no_grad():
        if args.points:
            pts = torch.as_tensor(np.load(args.points).astype(np.float32), device=args.device)
            out = sample.evaluate_points_batched(mcfg, params, pts, args.t)
            np.save(args.out, out.cpu().numpy())
            print(json.dumps({"points": int(pts.shape[0]), "out": args.out}))
            return 0
        out = sample.grid_infer_any(g, mcfg, params, args.t).cpu().numpy()
    fields = {"sigma": out[..., 0], "u": np.moveaxis(out[..., 1:4], -1, 0)}
    if args.out.endswith(".vtk"):
        path = export.write_vtk(args.out, g, fields)
    else:
        path = export.save_fields_npz(args.out, g, fields, t=args.t)
    print(json.dumps({"grid": [g.nx, g.ny, g.nz], "t": args.t, "out": path}))
    return 0


def _parse_obstacles(g, specs, device):
    """--obstacle values -> fluid mask (None when no obstacles).

    Syntax (cell indices, z-y-x order like the array layout):
      box:z0,y0,x0:z1,y1,x1     solid box over [lo, hi)
      sphere:cz,cy,cx:r         solid sphere, physical-unit radius
    """
    if not specs:
        return None
    from phys_autodiff_tpu_torch.ops import obstacles

    masks = []
    for s in specs:
        parts = s.split(":")
        try:
            if parts[0] == "box" and len(parts) == 3:
                lo = [int(v) for v in parts[1].split(",")]
                hi = [int(v) for v in parts[2].split(",")]
                masks.append(obstacles.box_mask(g, lo, hi, device=device))
            elif parts[0] == "sphere" and len(parts) == 3:
                c = [float(v) for v in parts[1].split(",")]
                masks.append(obstacles.sphere_mask(g, c, float(parts[2]), device=device))
            else:
                raise SystemExit(f"bad --obstacle {s!r}: expected box:z0,y0,x0:z1,y1,x1 or sphere:cz,cy,cx:r")
        except ValueError:  # a non-numeric coordinate is a usage error
            raise SystemExit(f"bad --obstacle {s!r}: coordinates must be numeric "
                             "(box:z0,y0,x0:z1,y1,x1 or sphere:cz,cy,cx:r)")
    return obstacles.validate_mask(g, obstacles.union(*masks))


def _parse_sources(g, emitters, fans, device):
    """--emitter / --fan values -> EulerSource (None when absent).

    Syntax (cell indices, z-y-x order):
      --emitter z0,y0,x0:z1,y1,x1:rate       smoke injection over [lo, hi)
      --fan     z0,y0,x0:z1,y1,x1:fz,fy,fx   constant momentum force
    """
    if not emitters and not fans:
        return None
    from phys_autodiff_tpu_torch.apps.euler import EulerSource

    rate = np.zeros(g.shape, np.float32)
    force = np.zeros((3,) + g.shape, np.float32)

    def _box(lo_s, hi_s):
        z0, y0, x0 = (int(v) for v in lo_s.split(","))
        z1, y1, x1 = (int(v) for v in hi_s.split(","))
        return (slice(z0, z1), slice(y0, y1), slice(x0, x1))

    for s in emitters:
        try:
            lo_s, hi_s, r = s.split(":")
            rate[_box(lo_s, hi_s)] += float(r)
        except (ValueError, TypeError):
            raise SystemExit(f"bad --emitter {s!r}: expected z0,y0,x0:z1,y1,x1:rate")
    for s in fans:
        try:
            lo_s, hi_s, f_s = s.split(":")
            fz, fy, fx = (float(v) for v in f_s.split(","))
            box = _box(lo_s, hi_s)
            force[(2,) + box] += fz
            force[(1,) + box] += fy
            force[(0,) + box] += fx
        except (ValueError, TypeError):
            raise SystemExit(f"bad --fan {s!r}: expected z0,y0,x0:z1,y1,x1:fz,fy,fx")
    return EulerSource(torch.as_tensor(rate, device=device), torch.as_tensor(force, device=device))


def cmd_simulate(args) -> int:
    from phys_autodiff_tpu_torch.apps import euler
    from phys_autodiff_tpu_torch.ops.obstacles import apply_no_slip
    from phys_autodiff_tpu_torch.utils import export

    dev = args.device
    with torch.no_grad():
        if args.ckpt:
            from phys_autodiff_tpu_torch.models import modelio

            g, mcfg, params = modelio.load_model(args.ckpt, device=dev)
            state = euler.initial_state_from_model(g, mcfg, params, t=args.t)
        else:
            g = _grid_from_args(args)
            rng = np.random.default_rng(args.seed)
            state = euler.EulerState(
                torch.as_tensor(rng.uniform(size=g.shape).astype(np.float32), device=dev),
                torch.as_tensor((0.3 * rng.normal(size=(3,) + g.shape)).astype(np.float32), device=dev),
            )
        cfg = euler.EulerConfig(dt=args.sim_dt, steps=args.steps_per_frame, buoyancy=args.buoyancy,
                                advection=args.advection, confinement=args.confinement,
                                projection="fft" if g.periodic else "cg")
        mask = _parse_obstacles(g, args.obstacle, dev)
        source = _parse_sources(g, args.emitter, args.fan, dev)
        if mask is not None:
            state = euler.EulerState(state.sigma * mask, apply_no_slip(state.u, mask))
        frames, diags = [], []
        for _ in range(args.frames):
            state, diag = euler.rollout(g, state, cfg, mask=mask, source=source)
            frames.append({"sigma": state.sigma.cpu().numpy(), "u": state.u.cpu().numpy()})
            diags.append(float(diag["max_abs_div"][-1]))
    paths = export.write_vtk_series(args.out, g, frames, dt_frame=args.sim_dt * args.steps_per_frame)
    print(json.dumps({
        "frames": len(paths), "series": args.out + ".vtk.series",
        "final_max_abs_div": diags[-1],
    }))
    return 0


def cmd_export(args) -> int:
    from phys_autodiff_tpu_torch.models import modelio
    from phys_autodiff_tpu_torch.utils import export

    fields, meta = export.load_fields_npz(args.input)
    g = modelio.grid_from_meta({k: meta[k] for k in _GRID_KEYS})
    path = export.write_vtk(args.out, g, fields)
    print(json.dumps({"fields": sorted(fields), "out": path}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="phys_autodiff_tpu_torch",
                                 description="PyTorch/CUDA differentiable-physics framework CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="torch device / model families")

    p = sub.add_parser("train", help="physics-residual training")
    _add_grid_args(p)
    _add_model_args(p)
    _add_opt_args(p)
    p.add_argument("--t", type=float, default=0.25, help="snapshot time")
    p.add_argument("--backward", choices=["auto", "mega", "xla"], default="auto",
                   help="encoded families: gradient engine")
    p.add_argument("--out", required=True, help="model checkpoint path")
    _add_device_arg(p)

    p = sub.add_parser("fit", help="fit a neural field to snapshot .npz(s)")
    p.add_argument("--target", action="append", required=True, help="snapshot .npz from utils.export (repeatable)")
    _add_model_args(p)
    _add_opt_args(p)
    p.add_argument("--phys-weight", type=float, default=0.0, help="PINN composite: weight of the physics residual")
    p.add_argument("--engine", choices=["auto", "mega", "xla"], default="auto",
                   help="gradient engine: mega = one kernel call per term (K6 / K7, K4 / K5)")
    p.add_argument("--out", required=True, help="model checkpoint path")
    _add_device_arg(p)

    p = sub.add_parser("serve", help="evaluate a model checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--t", type=float, default=0.25)
    p.add_argument("--points", help=".npy of [P,3] unit-cube points (omit to infer the full grid)")
    p.add_argument("--out", required=True, help=".npz / .vtk (grid) or .npy (points)")
    _add_device_arg(p)

    p = sub.add_parser("simulate", help="Euler smoke rollout -> VTK series")
    _add_grid_args(p)
    p.add_argument("--ckpt", help="seed from a model checkpoint (grid args are then taken from it)")
    p.add_argument("--t", type=float, default=0.25, help="model time for the seed state")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--steps-per-frame", type=int, default=4)
    p.add_argument("--sim-dt", type=float, default=2e-3)
    p.add_argument("--buoyancy", type=float, default=0.5)
    p.add_argument("--confinement", type=float, default=0.0)
    p.add_argument("--advection", choices=["semi_lagrangian", "maccormack"], default="maccormack")
    p.add_argument("--obstacle", action="append", default=[],
                   help="solid obstacle (repeatable): box:z0,y0,x0:z1,y1,x1 or sphere:cz,cy,cx:r (cell indices, "
                        "z-y-x; sphere radius in physical units). Projection switches to the masked CGNR solve.")
    p.add_argument("--emitter", action="append", default=[],
                   help="smoke emitter (repeatable): z0,y0,x0:z1,y1,x1:rate, injects d sigma/dt = rate over the box")
    p.add_argument("--fan", action="append", default=[],
                   help="momentum source (repeatable): z0,y0,x0:z1,y1,x1:fz,fy,fx, a constant body force over the "
                        "box (pre-projection)")
    p.add_argument("--out", required=True, help="VTK series prefix")
    _add_device_arg(p)

    p = sub.add_parser("export", help="snapshot .npz -> VTK")
    p.add_argument("--input", required=True)
    p.add_argument("--out", required=True)

    return ap


_COMMANDS = {"info": cmd_info, "train": cmd_train, "fit": cmd_fit, "serve": cmd_serve, "simulate": cmd_simulate,
             "export": cmd_export}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return _COMMANDS[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
