#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (phys_autodiff_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, one line each (any failure raises and exits non-zero):
  1. device   require CUDA; print the card's name and power limit
  2. build    build the kernels from csrc/ (nvcc, sm_90a) and time it
  3. parity   each kernel vs its plain PyTorch version on the card, at the
              main path's shapes and at small ragged grids (both schemes,
              both boundaries, nz=1), with the tolerance beside each error
  4. slice    the forward slice end to end at 128x96x96, H=128, seed 777,
              t=0.25 through the user entry points (README quick start,
              fused_loss_pipeline, mega_loss_pipeline, entry(), the bench
              headline op), launch counts of every kernel, agreement of the
              arms, and the loss against the float64 oracle
  5. times    CUDA-event medians of each kernel and its plain version, and
              each kernel's own device time from a torch.profiler trace
Then one JSON line of per-kernel results and, last, the result line
{"ok": true, "device": {...}}.

The port imports torch and never jax; neither does this script. Weights
are random (seeded), as the port's init_params draws them.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def main() -> None:
    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # The plain versions run on the card too: keep their float32 matmuls
    # and convolutions out of TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from phys_autodiff_tpu.ref import oracle
    from phys_autodiff_tpu.utils import tolerances as tol
    from phys_autodiff_tpu.utils.config import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu.utils.metrics import max_abs_err, rel_l2_err
    from phys_autodiff_tpu_torch import ops
    from phys_autodiff_tpu_torch.entry import entry
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import mega as kmega
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.kernels import residuals as kres
    from phys_autodiff_tpu_torch.models import fields as fields_mod
    from phys_autodiff_tpu_torch.models import mlp
    from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
    from phys_autodiff_tpu_torch.utils.timing import cuda_time_ms, device_time_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    print(smi)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")

    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    params = mlp.init_params(cfg.dims, seed=777, device=dev)
    t = 0.25

    def spec(nx, ny, nz, **kw):
        return GridSpec(nx=nx, ny=ny, nz=nz, hx=0.05, hy=0.05, hz=0.05, dt=1e-3, **kw)

    def host(x):
        return x.detach().float().cpu().numpy()

    def rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    errs = {"residuals": 0.0, "mlp": 0.0, "mega": 0.0}

    def report(kernel, what, err, limit, metric="rel_l2"):
        check(np.isfinite(err) and err <= limit, f"{kernel} {what}: {metric} {err} > {limit}")
        print(f"phase 3 parity {kernel:9s} {what}: {metric} {err:.3e} <= {limit:.0e}")

    # ---- 3. kernel vs plain, on the card ---------------------------------
    flagship = spec(128, 96, 96)
    for g in (flagship, spec(96, 96, 64), spec(64, 64, 64)):
        tag = f"{g.nx}x{g.ny}x{g.nz}"
        fs = kmlp.generate_fields_fused(g, cfg, params, t)  # the main path's fields
        rs, ru = kres.residuals_fused(g, fs)
        rs_p, ru_p = kres.residuals_plain(g, fs)
        gs, gu = kres.loss_backward_fused(g, w, fs)
        gs_p, gu_p = kres.loss_backward_plain(g, w, fs)
        loss = kres.loss_forward_fused(g, w, fs)
        _, loss_p = kres.loss_partials_plain(g, w, fs)
        torch.cuda.synchronize()
        for what, a, b in (("R", (rs, ru), (rs_p, ru_p)), ("g", (gs, gu), (gs_p, gu_p))):
            for x, y in zip(a, b):
                ma = max_abs_err(host(x), host(y))
                if g is flagship:
                    errs["residuals"] = max(errs["residuals"], ma)
                report("residuals", f"{tag} {what} max", ma, tol.FUSED_VS_STAGED_MAX, "max_abs")
                report("residuals", f"{tag} {what}", rel_l2_err(host(x), host(y)),
                       tol.FUSED_VS_STAGED_REL)
        report("residuals", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)), 1e-6, "rel")

    rng = np.random.default_rng(0)
    for periodic in (True, False):
        for scheme in ("central", "upwind"):
            for dims in ((24, 16, 6), (16, 8, 1)):
                g = GridSpec(*dims, hx=0.5, hy=0.6, hz=0.7, dt=0.5, periodic=periodic, scheme=scheme)
                mk = lambda *s: torch.tensor(rng.uniform(-0.5, 0.5, s).astype(np.float32), device=dev)
                fs = FieldSnapshots(mk(*g.shape), mk(*g.shape), mk(*g.shape),
                                    mk(3, *g.shape), mk(3, *g.shape), mk(3, *g.shape))
                tag = f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'}"
                out = torch.cat([x.reshape(-1) for x in kres.residuals_fused(g, fs)])
                ref = torch.cat([x.reshape(-1) for x in kres.residuals_plain(g, fs)])
                report("residuals", f"{tag} R max", max_abs_err(host(out), host(ref)),
                       tol.FUSED_VS_STAGED_MAX, "max_abs")
                loss = kres.loss_forward_fused(g, w, fs)
                _, loss_p = kres.loss_partials_plain(g, w, fs)
                report("residuals", f"{tag} loss", max(rel(loss[k], loss_p[k]) for k in range(2)),
                       1e-6, "rel")

    g = flagship
    ts = fields_mod.slice_times(t, g.dt)
    tables = kmlp.fold_tables(g, cfg, params, ts)
    sig_p, u_p = kmlp.mlp_tables_plain(*tables)
    fs = kmlp.generate_fields_fused(g, cfg, params, t)
    torch.cuda.synchronize()
    for name, x, y in (("sigma", torch.stack(fs[:3]), sig_p), ("u", torch.stack(fs[3:]), u_p)):
        errs["mlp"] = max(errs["mlp"], max_abs_err(host(x), host(y)))
        report("mlp", f"128x96x96 H=128 3-slice {name}", rel_l2_err(host(x), host(y)),
               tol.MLP_INFER_REL)
    y1 = kmlp.grid_infer_fused(g, cfg, params, t)
    tables1 = kmlp.fold_tables(g, cfg, params, ts[1:2])
    s1, u1 = kmlp.mlp_tables_plain(*tables1)
    y1_p = torch.cat([s1[0][..., None], torch.movedim(u1[0], 0, -1)], dim=-1)
    report("mlp", "128x96x96 H=128 grid_infer", rel_l2_err(host(y1), host(y1_p)), tol.MLP_INFER_REL)
    del sig_p, u_p, s1, u1, y1_p

    for g in (flagship, spec(128, 64, 64)):
        tag = f"{g.nx}x{g.ny}x{g.nz}"
        loss = kmega.mega_loss_pipeline(g, w, cfg, params, t)
        tabs = kmlp.fold_tables(g, cfg, params, fields_mod.slice_times(t, g.dt))
        loss_p = ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs))
        two = kres.loss_forward_fused(g, w, kmlp.generate_fields_fused(g, cfg, params, t))
        torch.cuda.synchronize()
        err = max(rel(loss[k], loss_p[k]) for k in range(2))
        if g is flagship:
            errs["mega"] = max(abs(float(loss[k]) - float(loss_p[k])) for k in range(2))
        report("mega", f"{tag} loss vs plain", err, 1e-5, "rel")
        report("mega", f"{tag} loss vs K2->K1", max(rel(loss[k], two[k]) for k in range(2)), 1e-5, "rel")

    # Ragged tiles (nx, ny not multiples of the 32x8 tile), nz=1 and a z range
    # shorter than a block's: K2 and K3 at small grids, both boundaries.
    for dims, periodic, scheme in (((24, 13, 5), False, "upwind"), ((40, 9, 1), True, "central"),
                                   ((7, 3, 11), True, "upwind")):
        g = GridSpec(*dims, hx=0.3, hy=0.3, hz=0.3, dt=1e-2, periodic=periodic, scheme=scheme)
        tag = f"{dims[0]}x{dims[1]}x{dims[2]} {scheme} {'periodic' if periodic else 'clamp'}"
        tabs = kmlp.fold_tables(g, cfg, params, fields_mod.slice_times(t, g.dt))
        sig_p, u_p = kmlp.mlp_tables_plain(*tabs)
        fs = kmlp.generate_fields_fused(g, cfg, params, t)
        x = torch.cat([torch.stack(fs[:3]).reshape(-1), torch.stack(fs[3:]).reshape(-1)])
        y = torch.cat([sig_p.reshape(-1), u_p.reshape(-1)])
        report("mlp", f"{tag} fields", rel_l2_err(host(x), host(y)), tol.MLP_INFER_REL)
        loss = kmega.mega_loss_pipeline(g, w, cfg, params, t)
        loss_p = ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs))
        report("mega", f"{tag} loss vs plain", max(rel(loss[k], loss_p[k]) for k in range(2)), 1e-5,
               "rel")
    torch.cuda.empty_cache()

    # ---- 4. the slice end to end -----------------------------------------
    g = flagship
    _build.reset_launches()
    fields = kmlp.generate_fields_fused(g, cfg, params, t)      # README quick start
    r_sigma, r_u = kres.residuals_fused(g, fields)
    readme = ops.loss_terms(g, w, r_sigma, r_u)
    fused = kmlp.fused_loss_pipeline(g, w, cfg, params, t)       # K2 -> K1 partials
    mega = kmega.mega_loss_pipeline(g, w, cfg, params, t)        # K3
    fn, args = entry(dev)                                        # the flagship entry
    entry_loss = fn(*args)
    packed = kmlp.generate_fields_fused_packed(g, cfg, params, t)
    headline = kres.residuals_fused_packed(g, packed)            # the bench headline op
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"phase 4 slice launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    plain = ops.loss_forward(g, w, fields_mod.generate_fields(g, cfg, params, t, g.dt))
    ls_o, lu_o = oracle.loss_forward(g, w, *[host(x) for x in fields])
    check(tuple(headline.shape) == (4,) + g.shape, "headline output shape")
    check(bool(torch.isfinite(headline).all()), "headline residuals finite")
    check(bool(torch.isfinite(entry_loss)), "entry loss finite")
    for name, arm in (("readme", readme), ("fused", fused), ("mega", mega)):
        check(all(bool(torch.isfinite(x)) for x in arm), f"{name} loss finite")
        d_plain = max(rel(arm[k], plain[k]) for k in range(2))
        d_oracle = max(rel(arm[0], ls_o), rel(arm[1], lu_o))
        print(f"phase 4 slice {name:6s}: L_sigma {float(arm[0]):.9g} L_u {float(arm[1]):.9g} "
              f"rel vs plain {d_plain:.3e} (<= 1e-5), vs f64 oracle {d_oracle:.3e} (<= 1e-6)")
        check(d_plain <= 1e-5, f"{name} vs plain path")
        check(d_oracle <= 1e-6, f"{name} vs f64 oracle")
    print(f"phase 4 slice plain : L_sigma {float(plain[0]):.9g} L_u {float(plain[1]):.9g}; "
          f"oracle {float(ls_o):.9g} {float(lu_o):.9g}; entry 128x64x64 loss {float(entry_loss):.9g}")
    del fields, r_sigma, r_u, packed, headline
    torch.cuda.empty_cache()

    # ---- 5. times ---------------------------------------------------------
    fs = kmlp.generate_fields_fused(g, cfg, params, t)
    packed = kres.pack_fields(fs)
    times = {}

    def short(kernel_name):
        m = re.search(r"k_\w+(<\d+>)?", kernel_name)
        return m.group(0) if m else kernel_name.split("(")[0][-40:]

    def both(name, kernel_fn, plain_fn, note):
        ms, plain_ms = cuda_time_ms(kernel_fn), cuda_time_ms(plain_fn)
        times[name] = (ms, plain_ms)
        print(f"phase 5 times {name:22s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms {note}")
        per_kernel = device_time_ms(kernel_fn)
        if per_kernel:
            dev_ms = sum(per_kernel.values())
            split = ", ".join(f"{short(k)} {v:.4f}" for k, v in sorted(per_kernel.items()))
            print(f"phase 5 device {name:21s}: {dev_ms:.4f} ms on the device per call "
                  f"({100 * dev_ms / ms:.0f}% of the event time): {split}")
        else:
            print(f"phase 5 device {name:21s}: not measured (the profiler saw no device time)")
        return ms

    ms = both("residuals packed R", lambda: kres.residuals_fused_packed(g, packed),
              lambda: kres.residuals_plain(g, fs), "(128x96x96)")
    print(f"phase 5 times residual throughput: {g.num_cells / (ms * 1e-3) / 1e9:.3f} G cell-iters/s "
          f"(kernel), {64 * g.num_cells / (ms * 1e-3) / 1e9:.1f} GB/s compulsory")
    both("residuals loss", lambda: kres.loss_forward_fused_packed(g, w, packed),
         lambda: kres.loss_partials_plain(g, w, fs), "(partials epilogue)")
    both("residuals scaled g", lambda: kres.loss_backward_fused_packed(g, w, packed),
         lambda: kres.loss_backward_plain(g, w, fs), "(scaled epilogue)")
    both("mlp 3-slice packed", lambda: kmlp.generate_fields_fused_packed(g, cfg, params, t),
         lambda: kmlp.mlp_tables_plain(*kmlp.fold_tables(g, cfg, params, ts)), "(H=128)")
    tabs = kmlp.fold_tables(g, cfg, params, ts)
    both("mega", lambda: kmega.mega_loss_pipeline(g, w, cfg, params, t),
         lambda: ops.sum_partials(g, w, kmega.mega_partials_plain(g, *tabs)), "(H=128)")
    both("slice fused pipeline", lambda: kmlp.fused_loss_pipeline(g, w, cfg, params, t),
         lambda: ops.loss_forward(g, w, fields_mod.generate_fields(g, cfg, params, t, g.dt)),
         "(K2 -> K1 vs staged plain)")

    sources = {"residuals": "residuals.cu", "mlp": "mlp.cu", "mega": "mega.cu"}
    replaces = {
        "residuals": "phys_autodiff_tpu/pallas/residuals.py:392,508,778",
        "mlp": "phys_autodiff_tpu/pallas/mlp.py:199",
        "mega": "phys_autodiff_tpu/pallas/mega.py:316",
    }
    timed = {"residuals": "residuals packed R", "mlp": "mlp 3-slice packed", "mega": "mega"}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"phys_autodiff_tpu_torch/csrc/{sources[name]}",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[timed[name]][0],
            "plain_ms": times[timed[name]][1],
        }
        for name in ("residuals", "mlp", "mega")
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
