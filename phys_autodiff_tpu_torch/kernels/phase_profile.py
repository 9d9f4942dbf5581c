"""Clock64 split of the kernels K2-K8 by barrier, on the card.

    python -m phys_autodiff_tpu_torch.kernels.phase_profile [--kernel NAME ...]

NAME: mlp, mega, mega_bwd, mega_ngp, fit, fit_ngp or transport (all seven
by default; mlp, mega, mega_bwd, fit and fit_ngp run their bf16 kernels
beside the f32 ones, mlp its bf16x3 kernel too, and mega_ngp its bf16 and
f32_fastbwd kernels). Copies csrc/ to build/phase_profile/, and in the
copies of mlp.cu (K2), mega.cu (K3), mega_bwd.cu (K4), mega_ngp.cu (K5),
fit.cu (K6), fit_ngp.cu (K7) and transport.cu (K8, K8c) instruments every
__global__ kernel the file defines: a timestamp after every
__syncthreads() and one at the kernel's end (thread 0 of each block adds
the cycles since the block's last timestamp to a counter of that mark, and
counts the block), plus one at the end of k_ngp_fields' and
k_ngp_fields_bf16's row work, two inside k_ngp_adjoint_bf16's row interval
(after dEnc of the row before, after the row's products; the interval's own
barrier then ends the next row's A), four inside k_ngp_fit_bf16's (after
dEnc of the row before, the row's backward, the encoding copy of the row
after next and the next row's forward; the interval's barrier then ends the
row's loss sums), five inside k_bwd_adjoint_bf16's chunk (at the top of each
tile row, after A's row of the next chunk there, before the tile row's dAB
slot stores, after the last tile row and after the dCD stores: A, B's
products, the slot stores and the dCD stores apart), one inside
k_fit_bf16's chunk (after the next chunk's CD copies are issued; its own
barriers then end the forward and the backward), one inside the bf16
k_mega's forward (after the tile rows' two passes, so that the chunk's
next barrier ends the halo pass) and, in
k_transport's plane loop, one after the next plane's copies are issued,
one after the x and y sweeps and one after the z sweep and its store (so
the plane's own barrier counts the wait for its copies alone). These extra
marks are barriers the kernel does not have. In the bf16 forward of K2 and
K4's fields pass (mlp_mma.cuh, inlined into mlp.cu and mega_bwd.cu) lane 0
of each warp laps the clock instead, with no barrier: the cycles of each
k-step's products, of its wait for the ring's AB slab and of each group's
stores, summed in registers a chunk (LAPS; printed as cycles a warp). A header named after the source
(an older tree's mega.cuh, which held K3's body) is inlined first, so its
kernels count as the file's. Kernels of the shared headers (K1's residual
pass, the sums) are not instrumented; their time is in chip_smoke.py's
"phase 5 split" lines. It builds that copy with the same nvcc flags, runs
each chosen kernel's wrapper at 128x96x96 (K2: the 3-slice packed fields,
K3: the loss partials, K4 and K6: the H=128 MLP's tables, seed 777 and 0,
t = 0.25; K5 and K7: NGPFieldConfig(), seed 777; K8 at C = 1 and 3 and
K8c on the transport-bench field, CFL 0.8, and K8 at C = 1 on 256^3;
the instantiations of one kernel template share its counters, so each
runs apart), and prints, for each
mark (with its source line), the cycles a block of its kernel spent since
the mark before: the time of the phase between them, waiting at the
barrier included. Two blocks share an SM, so a phase's cycles are wall
time of a block, not issue slots of the SM. The counters add with integer
atomics; the kernels' float results are untouched.

Run it from the repository root on a machine with the card, e.g.
`python3 -m phys_autodiff_tpu_torch.kernels.phase_profile --kernel mlp mega`
(about 15 s after the build). It also runs in a `git archive` of an older
commit with this file copied in, to split that tree's kernels. Nothing here
runs at import time.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess

STEMS = ("mlp", "mega", "mega_bwd", "mega_ngp", "fit", "fit_ngp", "transport")
_SLOTS = 64  # counters: marks from the front, one block count per kernel from the back

_PRELUDE = r"""
static __device__ unsigned long long g_phase[64];
#define PHASE_MARK(k) do { __syncthreads(); if (threadIdx.x == 0) { \
    const unsigned long long now_ = clock64(); atomicAdd(&g_phase[k], now_ - phase_t); phase_t = now_; } } while (0)
#define PHASE_START(k) unsigned long long phase_t = clock64(); \
    if (threadIdx.x == 0) atomicAdd(&g_phase[63 - (k)], 1ull)
extern "C" int pat_phase_read_STEM(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int pat_phase_reset_STEM() {
  unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
# Code after which a mark is inserted: (anchor, the mark's comment). The
# first ends k_ngp_fields' row loop body; the others split k_transport's
# plane loop. An anchor that a source lacks (an older tree's) is skipped.
_ANCHORS = (
    ("acc[k][o] + b2r[o];\n    }\n", "fields: y of the three slices, fbuf stores"),
    ("y[mi][sl][2 * half + j] + bo[j];\n          }\n        }\n    }\n",
     "fields bf16: base and y of the three slices, fbuf stores"),
    ("if (ndz == 2 && want && r > r0) denc_of(r - 1, dzb + (bb ^ 1) * dst);\n", "adjoint bf16: dEnc of the row before"),
    ("products(bb, want ? dzb + (ndz == 2 ? bb : 0) * dst : nullptr);\n", "adjoint bf16: the row's products"),
    ("      // ---- tile row yl: A's row of the next chunk, then B\n",
     "adjoint bf16: the tile row before's slot stores and dW2T sums, or the chunk's set-up"),
    ("      if (yl < na) stage_a(next, nb, yl);\n", "adjoint bf16: A, a row of the next chunk"),
    ("      // ---- the tile row's dAB partials to the block's slot\n", "adjoint bf16: B, the tile row's products"),
    ("    // The rows' dCD (the two slots of a hidden unit added) leave the warp.\n",
     "adjoint bf16: the last tile row's slot stores and dW2T sums"),
    ("dcw[((zl * 3 + s) * 16 + hh) * 2 + 1];\n    }\n", "adjoint bf16: the dCD stores"),
    ("    if (ndz == 2 && want && r > r0) denc_of(r - 1, dzb + (ib ^ 1) * dst);\n",
     "fit bf16: dEnc of the row before"),
    ("    backward(i % 3, ib, want ? dzb + (ndz == 2 ? ib : 0) * dst : nullptr);\n", "fit bf16: the row's backward"),
    ("    if (r + 2 < r1) store_of(r + 2, (i + 2) % 3, nxt);\n", "fit bf16: the encoding copy of the row after next"),
    ("    if (r + 1 < r1) forward(r + 1, (i + 1) % 3, ib ^ 1, ib ^ 1, tg);\n", "fit bf16: the next row's forward"),
    ("      copy_cd<ZC>(cd_s + ((k + 1) & 1) * ZC * HP, cd, mlph::chunk_at(r + c.n, r1, ZC, nz, ntx), H, HP);\n",
     "fit mlp bf16: the next chunk's CD copies issued"),
    ("      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 1);\n",
     "mega bf16: the tile rows' passes (own rows, outer rows)"),
    ("issue(k + STAGES - 1);\n    async_commit();\n", "transport: the next plane's copies issued"),
    ("      bp[c] = sweep_o(a[1], a[0], a[2], oy);\n    }\n", "transport: x and y sweeps"),
    ("out[c * n + o] = sweep_o(bc[c], bm[c], bp[c], oz);\n    }\n", "transport: z sweep and store"),
    ("out[c * n + o] = sweep(bc[c], bm[c], bp[c], d);\n      }\n    }\n", "transport: y and z sweeps and store"),
)
# Warp laps in the bf16 forward of K2 and K4's fields pass (mlp_mma.cuh,
# inlined into mlp.cu and mega_bwd.cu): lane 0 of each warp adds the cycles
# since the warp's last lap to counter LAP0 + i, kept in registers of the
# warp's AbRing and added once a chunk: (anchor, code inserted after it).
LAP0 = 40
LAPS = ("the k-step's products", "the AB wait (the ring's slab of the k-step)", "the stores of a group")
_LAP = "{ const unsigned long long n_ = clock64(); %s.lap[%d] += n_ - %s.lap_t; %s.lap_t = n_; }"
_LAP_ANCHORS = (
    ("  int igr, im;        // the next slab's group and tile\n",
     "  unsigned long long lap_t, lap[3];  // phase_profile's warp laps\n"),
    ("  __device__ __forceinline__ unsigned next() {\n", "    " + _LAP % ("(*this)", 0, "(*this)", "(*this)") + "\n"),
    ("    __syncwarp();  // every lane's copies of this slab in; the last slab's reads done\n",
     "    " + _LAP % ("(*this)", 1, "(*this)", "(*this)") + "\n"),
    ("    fwd_pass<S, R, X3, RING>(ring, w2f, w2f_lo, cdv + zl * rstride, stride, rstride, acc);\n",
     "    " + _LAP % ("ring", 0, "ring", "ring") + "\n"),
    ("    done(zl, acc, std::integral_constant<int, R>{});\n", "    " + _LAP % ("ring", 2, "ring", "ring") + "\n"),
    ("  if (gy < ny) {  // warp-uniform\n", "    ring.lap_t = clock64(), ring.lap[0] = ring.lap[1] = ring.lap[2] = 0;\n"),
    ("      });\n    }\n",
     "    if ((threadIdx.x & 31) == 0)\n      for (int i_ = 0; i_ < 3; ++i_) atomicAdd(&g_phase[%d + i_], ring.lap[i_]);\n" % LAP0),
)
_KERNEL = re.compile(r"__global__\s+void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\s*\(")


def _kernels(text: str) -> list[tuple[str, int, int]]:
    """(name, body start, body end) of each __global__ kernel: the offsets
    just inside its braces."""
    out = []
    for m in _KERNEL.finditer(text):
        depth, i = 1, m.end()
        while depth:  # the parameter list
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        start = text.index("{", i) + 1
        depth, i = 1, start
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        out.append((m.group(1), start, i - 1))
    return out


def _inline_own_header(text: str, path) -> str:
    """The source with `#include "<stem>.cuh"` replaced by that header's
    text, and `#include "mlp_mma.cuh"` by that header's with the warp laps
    (_LAP_ANCHORS) in it."""
    include = f'#include "{path.stem}.cuh"'
    header = path.with_suffix(".cuh")
    if include in text and header.exists():
        text = text.replace(include, header.read_text().replace("#pragma once", ""))
    mma = path.with_name("mlp_mma.cuh")
    if '#include "mlp_mma.cuh"' in text and mma.exists():
        body = mma.read_text().replace("#pragma once", "")
        for anchor, code in _LAP_ANCHORS:
            body = body.replace(anchor, anchor + code)
        text = text.replace('#include "mlp_mma.cuh"', body)
    return text


def _instrument(text: str, stem: str) -> tuple[str, list[tuple[str, str]], list[str]]:
    """The instrumented source, the (kernel, source line) of each mark and
    the instrumented kernels' names in order."""
    for anchor, what in _ANCHORS:
        text = text.replace(anchor, f"{anchor}    __syncthreads();  // {what}\n")
    pieces, pos, names, count = [], 0, [], [0]

    def mark(_):
        count[0] += 1
        return f"PHASE_MARK({count[0] - 1});"

    for k, (name, start, end) in enumerate(_kernels(text)):
        body = re.sub(r"__syncthreads\(\);", mark, text[start:end])
        body = f"\n  PHASE_START({k});{body}  PHASE_MARK({count[0]});  // {name}: end\n"
        count[0] += 1
        pieces += [text[pos:start], body]
        pos = end
        names.append(name)
    text = "".join(pieces) + text[pos:]
    head = text.index("namespace {")
    text = text[:head] + _PRELUDE.replace("STEM", stem) + text[head:]
    marks, kernel = [], None
    for line in text.splitlines():
        if "PHASE_START(" in line and "#define" not in line:
            kernel = names[int(re.search(r"PHASE_START\((\d+)\)", line).group(1))]
        for _ in re.findall(r"PHASE_MARK\(\d+\)", line if "#define" not in line else ""):
            marks.append((kernel, line.strip()))
    if len(marks) > LAP0 or LAP0 + len(LAPS) + len(names) > _SLOTS:
        raise RuntimeError(f"{stem}.cu: {len(marks)} marks and {len(names)} kernels exceed {_SLOTS} counters")
    return text, marks, names


def _build_library(stems):
    from phys_autodiff_tpu_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "phase_profile"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    marks = {}
    for stem in stems:
        path = out / f"{stem}.cu"
        text, stem_marks, names = _instrument(_inline_own_header(path.read_text(), path), stem)
        marks[stem] = (stem_marks, names)
        path.write_text(text)
    nvcc = _build.find_nvcc()
    objs, procs = [], []
    for src in sorted(out.glob("*.cu")):
        obj = out / f"{src.stem}.o"
        objs.append(str(obj))
        procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{err[-4000:]}")
    lib_path = out / "libphase.so"
    subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(lib_path), *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.pat_error_string.argtypes = [ctypes.c_int]
    lib.pat_error_string.restype = ctypes.c_char_p
    return lib, marks


def _transport_field(g, dev, seed=0, cfl=0.8):
    """chip_smoke.py's transport_field: sigma ~ N(0, 1) and a frozen random
    velocity whose offsets reach +-cfl cells."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sigma = rng.normal(size=g.shape).astype(np.float32)
    u = (rng.uniform(-cfl, cfl, size=(3,) + g.shape) * np.array([g.hx, g.hy, g.hz])[:, None, None, None]
         / g.dt).astype(np.float32)
    return torch.tensor(sigma, device=dev), torch.tensor(u, device=dev)


def _runs(dev):
    """Each kernel's wrapper at 128x96x96 (and K8 at 256^3), as a list of
    (what, zero-argument call) per source."""
    import dataclasses

    import torch

    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega as k3
    from phys_autodiff_tpu_torch.kernels import mega_bwd as k4
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.kernels import transport as ktr
    from phys_autodiff_tpu_torch.models import encoders, mlp, ngp
    from phys_autodiff_tpu_torch.models.fields import slice_times

    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    w = PhysWeights()
    t = torch.full((), 0.25, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    target = kfit.pack_target(g, torch.randn(g.shape, device=dev, generator=gen),
                              torch.randn((3,) + g.shape, device=dev, generator=gen))
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    p3 = mlp.init_params(cfg.dims, seed=777, device=dev)
    tabs3 = kmlp.fold_tables(g, cfg, p3, slice_times(t, g.dt))
    tabs1 = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=0, device=dev), t.reshape(1))
    ncfg = ngp.NGPFieldConfig()
    p = ngp.init_ngp_params(ncfg, seed=777, device=dev)
    enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g).contiguous()
    head = (enc, *(p[k].contiguous() for k in ("W1", "b1", "W2", "b2")))
    enc_fast = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g, fast=True).contiguous()
    head_fast = (enc_fast, *head[1:])
    sigma, u = _transport_field(g, dev)
    w8 = ktr.transport_weights(g, u, g.dt)
    big = dataclasses.replace(g, nx=256, ny=256, nz=256)
    sigma_big, u_big = _transport_field(big, dev)
    return {
        "mlp": [("128x96x96, the H=128 MLP, 3 slices packed",
                 lambda: kmlp.generate_fields_fused_packed(g, cfg, p3, 0.25)),
                ("128x96x96, the H=128 MLP, 3 slices packed, bf16",
                 lambda: kmlp.generate_fields_fused_packed(g, cfg, p3, 0.25, "bf16")),
                ("128x96x96, the H=128 MLP, 3 slices packed, bf16x3",
                 lambda: kmlp.generate_fields_fused_packed(g, cfg, p3, 0.25, "bf16x3"))],
        "mega": [("128x96x96, the H=128 MLP", lambda: k3._mega_partials(g, w, *tabs3)),
                 ("128x96x96, the H=128 MLP, bf16", lambda: k3._mega_partials(g, w, *tabs3, "bf16"))],
        "mega_bwd": [("128x96x96, the H=128 MLP", lambda: k4.table_loss_and_grad(g, w, *tabs3)),
                     ("128x96x96, the H=128 MLP, bf16", lambda: k4.table_loss_and_grad(g, w, *tabs3, "bf16"))],
        "mega_ngp": [("128x96x96, NGPFieldConfig()",
                      lambda: k5.head_loss_and_grad(g, w, *head, slice_times(t, g.dt))),
                     ("128x96x96, NGPFieldConfig(), bf16 (the fast encode)",
                      lambda: k5.head_loss_and_grad(g, w, *head_fast, slice_times(t, g.dt), "bf16")),
                     ("128x96x96, NGPFieldConfig(), f32_fastbwd",
                      lambda: k5.head_loss_and_grad(g, w, *head, slice_times(t, g.dt), "f32_fastbwd"))],
        "fit": [("128x96x96, the H=128 MLP", lambda: kfit.fit_table_loss_and_grad(g, w, *tabs1, target)),
                ("128x96x96, the H=128 MLP, bf16",
                 lambda: kfit.fit_table_loss_and_grad(g, w, *tabs1, target, "bf16"))],
        "fit_ngp": [("128x96x96, NGPFieldConfig()", lambda: kfit.ngp_fit_head_loss_and_grad(g, w, *head, t, target)),
                    ("128x96x96, NGPFieldConfig(), bf16 (the fast encode)",
                     lambda: kfit.ngp_fit_head_loss_and_grad(g, w, *head_fast, t, target, "bf16"))],
        "transport": [
            ("128x96x96, K8 C=1, the transport-bench field", lambda: ktr.transport_step_fused(g, sigma, u, g.dt)),
            ("128x96x96, K8 C=3, u advecting itself", lambda: ktr.transport_step_many_fused(g, u, u, g.dt)),
            ("128x96x96, K8c, the six weight planes", lambda: ktr.transport_step_fused_pre(g, sigma, w8)),
            ("256x256x256, K8 C=1", lambda: ktr.transport_step_fused(big, sigma_big, u_big, big.dt)),
        ],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=STEMS, default=list(STEMS),
                    help="the kernel sources to instrument and run (default: all)")
    args = ap.parse_args(argv)
    import torch

    from phys_autodiff_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("phase_profile needs a CUDA card")
    lib, marks = _build_library(args.kernel)
    saved, _build._lib = _build._lib, lib
    try:
        dev = torch.device("cuda", 0)
        runs = _runs(dev)
        calls = 5
        for stem in args.kernel:
            stem_marks, names = marks[stem]
            for what, fn in runs[stem]:
                fn()
                torch.cuda.synchronize()
                getattr(lib, f"pat_phase_reset_{stem}")()
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                counts = (ctypes.c_ulonglong * _SLOTS)()
                getattr(lib, f"pat_phase_read_{stem}")(counts)
                blocks = {name: counts[_SLOTS - 1 - k] / calls for k, name in enumerate(names)}
                print(f"phase_profile {stem}.cu ({what}): cycles a block by the mark that "
                      f"ends each phase; blocks a call: " + ", ".join(f"{n} {b:.0f}" for n, b in blocks.items()))
                cycles = [counts[i] / calls / max(blocks[k], 1) for i, (k, _) in enumerate(stem_marks)]
                for name in names:
                    if not blocks[name]:
                        continue
                    total = sum(c for c, (k, _) in zip(cycles, stem_marks) if k == name) or 1
                    for c, (k, line) in zip(cycles, stem_marks):
                        if k == name:
                            print(f"  {c:10.0f} ({100 * c / total:3.0f}%)  {line[:96]}")
                laps = [counts[LAP0 + i] / calls for i in range(len(LAPS))]
                warps = 8 * max(blocks.values())
                if any(laps) and warps:
                    print(f"  warp laps of the bf16 forward (cycles a warp, {warps // 8:.0f} blocks of 8 warps):")
                    for what, c in zip(LAPS, laps):
                        print(f"  {c / warps:10.0f} ({100 * c / sum(laps):3.0f}%)  {what}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        print(f"phase_profile card: {smi}")
    finally:
        _build._lib = saved


if __name__ == "__main__":
    main()
