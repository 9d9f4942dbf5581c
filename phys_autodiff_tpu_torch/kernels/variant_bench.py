"""Time edited copies of the kernel sources against the tree's own, on one
card, in turns.

    python -m phys_autodiff_tpu_torch.kernels.variant_bench [--variant NAME ...] [--turns N]

A variant is a list of text edits (file under csrc/, the text to find, its
replacement) and the kernel call it is timed on. Each variant's sources go
to build/variants/<name>/ with its edits applied; a variant whose text is
not in the sources (another tree's) is reported and skipped. The tree's own
sources and every variant's are compiled at once (one nvcc a source that
differs from the tree's; a variant that edits a header recompiles every
source), each linked into a library of its own. One process then times
them in turns (the tree, each variant, then back in the other order, as
often as --turns says): the Python wrappers are this tree's, and the
library under them is swapped, as phase_profile does. Per turn it prints
the device time of each launch of the call (torch.profiler, 10 calls; a
turn that kept fewer records than launches is flagged and repeated once,
utils/timing.device_time_turn) and the CUDA-event median of 20, with the
card's name and power limit.

The variants below are knock-outs, which leave out a part of a kernel
(their outputs are wrong: the time that part holds, with everything else as
it runs), and alternatives to a design choice (their outputs are right,
and chip_smoke.py's checks do not run on them). They are written against
the sources before a redesign ("parent": K6 bf16's and K3 bf16's, K2
bf16's) and against the redesigned ones; each applies to the tree whose
sources hold its text. K2's are timed on K2 bf16 and bf16x3 at S = 3 and 1
and on K4 bf16 (its fields pass, k_bwd_fields, runs K2's routine).
Nothing here runs at import time.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess

#: The calls K2's variants are timed on: K2 bf16 and bf16x3 at S = 3 and
#: S = 1, and K4 bf16 (its fields pass runs K2's bf16 routine).
K2_CALLS = ("mlp bf16", "mlp bf16 S=1", "mlp bf16x3", "mlp bf16x3 S=1", "mega_bwd bf16")

# name: (the call or calls it is timed on, [(file, find, replace), ...])
VARIANTS = {
    # K2 bf16 / bf16x3 and K4 bf16's fields pass before their redesign
    # (csrc/mlp_mma.cuh fwd_tile and fields_chunk; mlp.cu, mega_bwd.cu)
    "K2 parent: AB a register value": (K2_CALLS, [(
        "mlp_mma.cuh",
        "  const int nkb = (H + 15) >> 4;\n#pragma unroll 1\n  for (int kb = 0; kb < nkb; ++kb) {\n    int hs[4];\n",
        "  const int nkb = (H + 15) >> 4;\n  const float ab_lo0 = __ldg(ab_lo), ab_hi0 = __ldg(ab_hi);\n"
        "#pragma unroll 1\n  for (int kb = 0; kb < nkb; ++kb) {\n    int hs[4];\n"), (
        "mlp_mma.cuh",
        "      al[j] = on ? __ldg(ab_lo + hs[j] * plane) : 0.f;\n      ah[j] = on ? __ldg(ab_hi + hs[j] * plane) : 0.f;\n",
        "      al[j] = on ? ab_lo0 : 0.f;\n      ah[j] = on ? ab_hi0 : 0.f;\n")]),
    "K2 parent: packs by PRMT": (K2_CALLS, [(
        "mlp_mma.cuh", "__device__ __forceinline__ void fwd_tile(", "__device__ __forceinline__ void fwd_tile("), (
        "mlp_mma.cuh",
        "  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n  return *reinterpret_cast<const uint32_t*>(&v);\n",
        "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n"), (
        "mlp_mma.cuh",
        "  const __nv_bfloat162 v = __hmax2(__floats2bfloat162_rn(lo, hi), __float2bfloat162_rn(0.f));\n"
        "  return *reinterpret_cast<const uint32_t*>(&v);\n",
        "  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n"), (
        "mlp_mma.cuh", "{ return x - __bfloat162float(__float2bfloat16_rn(x)); }",
        "{ return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u); }")]),
    "K2 parent: no stores": (K2_CALLS, [(
        "mlp_mma.cuh", "                              if (t >= 2) return;\n",
        "                              if (t >= 2 || nx > 0) return;\n")]),
    "K2 parent: no CD copy": (K2_CALLS, [(
        "mlp.cu", "    mlph::load_cd_rows<S, ZF + 1, P>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);\n",
        "    if (r == r0) mlph::load_cd_rows<S, ZF + 1, P>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);\n"), (
        "mega_bwd.cu", "    mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zc0 + c.z0, c.n, zr.nz, periodic, H, HP);\n",
        "    if (r == r0) mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zc0 + c.z0, c.n, zr.nz, periodic, H, HP);\n")]),
    "K2: no CD copy": (K2_CALLS, [(
        "mlp.cu", "    mlph::load_cd_rows<S, ZF + 1, P>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);\n",
        "    if (r == r0) mlph::load_cd_rows<S, ZF + 1, P>(cd_s, cd, S, 0, c.z0, c.n, nz, 0, H, HP);\n"), (
        "mega_bwd.cu", "    mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zr.z0 - zr.hz + c.z0, c.n, zr.nz, periodic, H, HP);\n",
        "    if (r == r0)\n"
        "      mlph::load_cd_rows<3, NROW, P>(cd_s, cd, 3, 0, zr.z0 - zr.hz + c.z0, c.n, zr.nz, periodic, H, HP);\n")]),
    # K2 bf16 / bf16x3 and K4 bf16's fields pass after their redesign
    # (csrc/mlp_mma.cuh fwd_pass, AbRing, fields_chunk)
    "K2: AB a register value": (K2_CALLS, [(
        "mlp_mma.cuh", "  __device__ __forceinline__ unsigned next() {\n",
        "  __device__ __forceinline__ unsigned next() {\n    if (FW_NS > 0) return st;\n"), (
        "mlp_mma.cuh",
        "        const float2 v = lds_f32x2(stg + 4 * u * FW_PS);\n        al[j] = v.x, ah[j] = v.y;\n",
        "        al[j] = 0.25f * u;\n        ah[j] = 0.5f * u;\n")]),
    "K2: packs by PRMT": (K2_CALLS, [(
        "mlp_mma.cuh", '  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\\n" : "=r"(r) : "f"(hi), "f"(lo));\n',
        "  r = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);\n"), (
        "mlp_mma.cuh", "  hi = pack2(x0, x1);\n", "  hi = __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);\n"), (
        "mlp_mma.cuh", "  lo = pack2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));\n",
        "  lo = __byte_perm(__float_as_uint(x0 - __uint_as_float(hi << 16)),\n"
        "                   __float_as_uint(x1 - __uint_as_float(hi & 0xffff0000u)), 0x7632);\n")]),
    "K2: no stores": (K2_CALLS, [(
        "mlp_mma.cuh", "          if (second && vb >= V) continue;\n",
        "          if ((second && vb >= V) || nx > 0) continue;\n")]),
    "K2: no ring (AB from device memory)": (K2_CALLS, [(
        "mlp_mma.cuh", "  return fixed + ring_bytes(FW_NS) <= cap ? FW_NS : 0;\n", "  return 0;\n")]),
    "K2: rings of 4 stages": (K2_CALLS, [(
        "mlp_mma.cuh", "constexpr int FW_NS = 2;", "constexpr int FW_NS = 4;")]),
    "K2: rings of 3 stages": (K2_CALLS, [(
        "mlp_mma.cuh", "constexpr int FW_NS = 2;", "constexpr int FW_NS = 3;")]),
    "K2: chunks of 8 rows at S = 3, 16 at S = 1": (K2_CALLS, [(
        "mlp.cu", "constexpr int ZF_OF = S == 3 ? 4 : 8;", "constexpr int ZF_OF = S == 3 ? 8 : 16;")]),
    # K6 bf16 before its redesign (csrc/fit.cu k_fit<true>)
    "K6 bf16 parent: no target loads": ("fit bf16", [(
        "fit.cu",
        "e0 = (acc[i][0][2 * half] + bo0) - __ldg(tp);\n"
        "                  e1 = (acc[i][0][2 * half + 1] + bo1) - __ldg(tp + plane);",
        "e0 = (acc[i][0][2 * half] + bo0) - 0.5f * (tp == nullptr);\n"
        "                  e1 = (acc[i][0][2 * half + 1] + bo1) - 0.5f;")]),
    "K6 bf16 parent: no phase B": ("fit bf16", [(
        "fit.cu", "for (int hb = warp; 16 * hb < H; hb += NW)\n        mma16::bwd_block(",
        "for (int hb = warp; H < 0 && 16 * hb < H; hb += NW)\n        mma16::bwd_block(")]),
    "K6 bf16 parent: CD rows preloaded": ("fit bf16", [(
        "fit.cu",
        "    mlph::load_cd<1>(cd_s, cd, c.z0, c.n, ZC, H, HP);\n"
        "    __syncthreads();  // fit: the chunk's CD rows in\n\n"
        "    // ---- A: the forward of every row, e, gy and the rows' squared errors --\n"
        "    if constexpr (BF16) {\n",
        "    if (r == r0) {\n      mlph::load_cd<1>(cd_s, cd, c.z0, c.n, ZC, H, HP);\n      __syncthreads();\n    }\n\n"
        "    // ---- A: the forward of every row, e, gy and the rows' squared errors --\n"
        "    if constexpr (BF16) {\n")]),
    # K3 bf16 before its redesign (csrc/mega.cu k_mega<true>, fwd_bf16)
    "K3 bf16 parent: no outer-row pass": ("mega bf16", [(
        "mega.cu", "      if (e == 0 ? !first : !last) continue;", "      if (e >= 0) continue;")]),
    "K3 bf16 parent: no halo pass": ("mega bf16", [(
        "mega.cu", "  if (warp < NHALO / 16) {  // the x/y halo, 16 cells a warp",
        "  if (warp < 0) {  // the x/y halo, 16 cells a warp")]),
    # K6 bf16 after its redesign (csrc/fit.cu bfit::k_fit_bf16)
    "K6 bf16: forward groups of 4 rows": ("fit bf16", [(
        "fit.cu", "constexpr int RMAX = 8;", "constexpr int RMAX = 4;")]),
    "K6 bf16: chunks of 16 rows": ("fit bf16", [(
        "fit.cu", "  const int zcs[4] = {24, 16, 8, 4};\n", "  const int zcs[4] = {16, 16, 8, 4};\n")]),
    "K6 bf16: chunks of 8 rows": ("fit bf16", [(
        "fit.cu", "  const int zcs[4] = {24, 16, 8, 4};\n", "  const int zcs[4] = {8, 8, 8, 4};\n")]),
    "K6 bf16: the mask by selects": ("fit bf16", [(
        "fit.cu",
        "              if (pre[r][i] > 0.f) {\n"
        "                const float dz = d[i >> 1][2 * r + (i & 1)];\n"
        "                dc[r] += dz;\n"
        "                dab[r][m][i] += dz;\n"
        "              }\n",
        "              const float dz = pre[r][i] > 0.f ? d[i >> 1][2 * r + (i & 1)] : 0.f;\n"
        "              dc[r] += dz;\n"
        "              dab[r][m][i] += dz;\n")]),
    "K6 bf16: no target loads": ("fit bf16", [(
        "fit.cu", "      tg[i][half][0] = __ldg(tp);\n      tg[i][half][1] = __ldg(tp + plane);\n",
        "      tg[i][half][0] = 0.5f * (tp == nullptr);\n      tg[i][half][1] = 0.5f;\n")]),
    "K6 bf16: no phase B": ("fit bf16", [(
        "fit.cu", "    for (int hb = warp; 16 * hb < H; hb += NW)\n      backward<ZC>(",
        "    for (int hb = warp; H < 0 && 16 * hb < H; hb += NW)\n      backward<ZC>(")]),
    "K6 bf16: no phase A": ("fit bf16", [(
        "fit.cu", "    forward<ZC>(FwdArgs{", "    if (H < 0) forward<ZC>(FwdArgs{")]),
    "K6 bf16: B without the slot traffic": ("fit bf16", [
        ("fit.cu", "          dab[r][m][i] = on && !first ? slr[r * 8 * NT + yl * TX + lx] : 0.f;\n",
         "          dab[r][m][i] = 0.f;\n"),
        ("fit.cu", "            if (hr[r] < H) slr[r * 8 * NT + yl * TX + lx] = dab[r][m][i];\n",
         "            if (hr[r] < 0) slr[r * 8 * NT + yl * TX + lx] = dab[r][m][i];\n")]),
    "K6 bf16: B's row pairs two at a time": ("fit bf16", [(
        "fit.cu", "#pragma unroll 1\n    for (int p = 0; p < np; ++p) {\n", "#pragma unroll 2\n    for (int p = 0; p < np; ++p) {\n")]),
    "K6 bf16: da1 of the tile row's four n8 tiles at once": ("fit bf16", [(
        "fit.cu",
        "          float d[2][4];\n"
        "#pragma unroll\n"
        "          for (int n = 0; n < 2; ++n) {\n"
        "#pragma unroll\n"
        "            for (int v = 0; v < 4; ++v) d[n][v] = 0.f;\n"
        "            mma1688(d[n], wa[e][0], wa[e][1], bn[2 * m + n]);\n"
        "          }\n",
        "          float d[2][4];\n"
        "#pragma unroll\n"
        "          for (int n = 0; n < 2; ++n) {\n"
        "#pragma unroll\n"
        "            for (int v = 0; v < 4; ++v) d[n][v] = dq[2 * m + n][v];\n"
        "          }\n"), (
        "fit.cu",
        "#pragma unroll\n        for (int m = 0; m < 2; ++m) {\n          // da1^T of the n8 tiles 2 m, 2 m + 1",
        "        float dq[4][4];\n"
        "#pragma unroll\n"
        "        for (int nn = 0; nn < 4; ++nn) {\n"
        "#pragma unroll\n"
        "          for (int v = 0; v < 4; ++v) dq[nn][v] = 0.f;\n"
        "          mma1688(dq[nn], wa[e][0], wa[e][1], bn[nn]);\n"
        "        }\n"
        "#pragma unroll\n        for (int m = 0; m < 2; ++m) {\n          // da1^T of the n8 tiles 2 m, 2 m + 1")]),
    # K3 bf16 after its redesign (csrc/mega.cu fwd_pass)
    "K3 bf16: chunks of 4 rows": ("mega bf16", [(
        "mega.cu", "constexpr int ZF_BF16 = 3;", "constexpr int ZF_BF16 = 4;")]),
    "K3 bf16: the passes in a loop": ("mega bf16", [(
        "mega.cu",
        "      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 0);\n"
        "      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 1);\n"
        "      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 2);\n",
        "#pragma unroll 1\n      for (int m = 0; m < 3; ++m)\n"
        "        fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, m);\n")]),
    "K3 bf16: no halo": ("mega bf16", [(
        "mega.cu", "      fwd_bf16<ZF>(ab, w2f, cd_s, win, dlt_s, b2, ci, nx, ny, periodic, H, 2);\n", "")]),
    "K3 bf16: no residuals": ("mega bf16", [(
        "mega.cu", "      if (valid && j < nr) {\n        const int q = c.z0 + k0 + j - za + 1;",
        "      if (H < 0 && valid && j < nr) {\n        const int q = c.z0 + k0 + j - za + 1;")]),
}


def _calls(dev):
    """The calls the variants are timed on: K6 bf16 and K3 bf16 at
    128x96x96 on the H=128 MLP's tables (seed 0 and 777, t = 0.25; the
    target N(0, 1), seed 0), K2 bf16 / bf16x3 (the packed 3-slice fields
    and grid_infer_fused's one slice, seed 777) and K4 bf16 on the seed-777
    tables, through their wrappers."""
    import numpy as np
    import torch

    from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega as k3
    from phys_autodiff_tpu_torch.kernels import mega_bwd as k4
    from phys_autodiff_tpu_torch.kernels import mlp as kmlp
    from phys_autodiff_tpu_torch.models import mlp
    from phys_autodiff_tpu_torch.models.fields import slice_times

    g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
    w = PhysWeights()
    t = torch.full((), 0.25, device=dev)
    cfg = MLPGridConfig(dims=MLPDims(H=128))
    rng = np.random.default_rng(0)
    target = torch.tensor(rng.standard_normal((g.nz, 4, g.ny * g.nx)).astype(np.float32), device=dev)
    tabs1 = kmlp.fold_tables(g, cfg, mlp.init_params(cfg.dims, seed=0, device=dev), t.reshape(1))
    p3 = mlp.init_params(cfg.dims, seed=777, device=dev)
    tabs3 = kmlp.fold_tables(g, cfg, p3, slice_times(t, g.dt))
    calls = {"fit bf16": lambda: kfit.fit_table_loss_and_grad(g, w, *tabs1, target, "bf16"),
             "mega bf16": lambda: k3._mega_partials(g, w, *tabs3, "bf16"),
             "mega_bwd bf16": lambda: k4.table_loss_and_grad(g, w, *tabs3, "bf16")}
    for tier in ("bf16", "bf16x3"):
        calls[f"mlp {tier}"] = lambda tier=tier: kmlp.generate_fields_fused_packed(g, cfg, p3, t, tier)
        calls[f"mlp {tier} S=1"] = lambda tier=tier: kmlp.grid_infer_fused(g, cfg, p3, 0.25, tier)
    return calls


def _call_names(name) -> tuple[str, ...]:
    """The calls a variant (or "tree") is timed on."""
    on = VARIANTS[name][0]
    return (on,) if isinstance(on, str) else tuple(on)


def _load(path):
    from phys_autodiff_tpu_torch.kernels import _build

    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.pat_error_string.argtypes = [ctypes.c_int]
    lib.pat_error_string.restype = ctypes.c_char_p
    return lib


def _build_all(names):
    """Build the tree's library and each variant's under build/variants/:
    {name: library path} (the tree's under "tree"), and the variants whose
    text the sources lack."""
    from phys_autodiff_tpu_torch.kernels import _build, sass_count

    root = _build.BUILD_DIR.parent / "variants"
    shutil.rmtree(root, ignore_errors=True)
    base = root / "tree"
    shutil.copytree(_build.CSRC_DIR, base)
    dirs, missing = {"tree": base}, []
    for k, name in enumerate(names):
        _, edits = VARIANTS[name]
        d = root / f"v{k}"
        shutil.copytree(_build.CSRC_DIR, d)
        ok = True
        for fname, find, repl in edits:
            text = (d / fname).read_text()
            if text.count(find) != 1:
                ok = False
                break
            (d / fname).write_text(text.replace(find, repl))
        if ok:
            dirs[name] = d
        else:
            missing.append(name)
            shutil.rmtree(d)
    nvcc = _build.find_nvcc()
    stems = sorted(p.stem for p in base.glob("*.cu"))
    jobs = []
    for name, d in dirs.items():
        header_edited = any((d / h.name).read_text() != h.read_text() for h in base.glob("*.cuh"))
        for stem in stems:
            src = d / f"{stem}.cu"
            if name == "tree" or header_edited or src.read_text() != (base / f"{stem}.cu").read_text():
                cmd = [nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(d / f"{stem}.o"), str(src)]
                jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for cmd, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {cmd[-1]}:\n{err[-4000:]}")
        for line in sass_count.ptxas_lines(err, ("",)):
            if " 0 / 0 bytes spill" not in line:
                print(f"variant_bench ptxas {cmd[-1]}: {line}")
    libs = {}
    for name, d in dirs.items():
        objs = [str(d / f"{s}.o") if (d / f"{s}.o").exists() else str(base / f"{s}.o") for s in stems]
        path = d / "libvariant.so"
        subprocess.run([nvcc, *_build.LINK_FLAGS, "-o", str(path), *objs], check=True)
        libs[name] = path
    return libs, missing


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS))
    ap.add_argument("--turns", type=int, default=2, help="rounds over the tree and the variants (default 2)")
    args = ap.parse_args(argv)
    import torch

    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.utils.timing import cuda_time_ms, device_time_turn

    if not torch.cuda.is_available():
        raise SystemExit("variant_bench needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    paths, missing = _build_all(args.variant)
    for name in missing:
        print(f"variant_bench {name}: its text is not in this tree's sources; skipped")
    libs = {name: _load(p) for name, p in paths.items()}
    dev = torch.device("cuda", 0)
    calls = _calls(dev)
    saved = _build._lib
    try:
        for turn in range(args.turns):
            order = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            for name in order:
                _build._lib = libs[name]
                on = _call_names(name) if name != "tree" else {c for v in libs if v != "tree" for c in _call_names(v)}
                for call in sorted(on):
                    # a turn that lost profiler records is flagged and repeated once
                    kt, bad = device_time_turn(calls[call], what=f"variant_bench turn {turn + 1} {name} ({call})")
                    split = {k: v.call_ms for k, v in kt.items()}
                    ev = cuda_time_ms(calls[call])
                    parts = ", ".join(f"{k[:40]} {v:.4f}" for k, v in sorted(split.items()))
                    print(f"variant_bench turn {turn + 1} {name} ({call}): {sum(split.values()):.4f} ms on the "
                          f"device, {ev:.4f} ms events ({parts})" + (" DROPPED RECORDS" if bad else ""))
    finally:
        _build._lib = saved
    print(f"variant_bench card: {smi}")


if __name__ == "__main__":
    main()
