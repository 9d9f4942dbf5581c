"""Clock64 split of the head kernels K5 and K7 by barrier, on the card.

    python -m phys_autodiff_tpu_torch.kernels.phase_profile

Copies csrc/ to build/phase_profile/, and in the copies of mega_ngp.cu and
fit_ngp.cu puts a timestamp after every __syncthreads() of their kernels
(thread 0 of each block adds the cycles since the block's last timestamp to
a counter of that barrier), plus one at the end of k_ngp_fields' row loop.
It builds that copy with the same nvcc flags, runs K5 (head_loss_and_grad)
and K7 (ngp_fit_head_loss_and_grad) at 128x96x96, NGPFieldConfig(), seed
777, and prints, for each barrier (with its source line), the cycles a
block spent since the barrier before: the time of the phase between them,
waiting at the barrier included. Two blocks share an SM, so a phase's
cycles are wall time of a block, not issue slots of the SM. The counters
add with integer atomics; the kernels' float results are untouched.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess

_PRELUDE = r"""
static __device__ unsigned long long g_phase[64];
#define PHASE_MARK(k) do { __syncthreads(); if (threadIdx.x == 0) { \
    const unsigned long long now_ = clock64(); atomicAdd(&g_phase[k], now_ - phase_t); phase_t = now_; } } while (0)
extern "C" int pat_phase_read_STEM(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
}
extern "C" int pat_phase_reset_STEM() {
  unsigned long long zero[64] = {};
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
_ROW_END = "acc[k][o] + b2r[o];\n    }\n"  # the end of k_ngp_fields' row loop body


def _instrument(text: str, stem: str) -> tuple[str, list[str]]:
    """The instrumented source and the source line of each mark."""
    text = text.replace("extern __shared__ float4 sh4[];",
                        "extern __shared__ float4 sh4[];\n  unsigned long long phase_t = clock64();")
    text = text.replace(_ROW_END, _ROW_END + "    __syncthreads();  // fields: y of the three slices, fbuf stores\n")
    count = [0]

    def mark(_):
        count[0] += 1
        return f"PHASE_MARK({count[0] - 1});"

    text = re.sub(r"__syncthreads\(\);", mark, text)
    head = text.index("namespace {")
    text = text[:head] + _PRELUDE.replace("STEM", stem) + text[head:]
    lines = [line.strip() for line in text.splitlines() if "PHASE_MARK(" in line and "#define" not in line]
    return text, lines


def _build_library():
    from phys_autodiff_tpu_torch.kernels import _build

    out = _build.BUILD_DIR.parent / "phase_profile"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    marks = {}
    for stem in ("mega_ngp", "fit_ngp"):
        path = out / f"{stem}.cu"
        text, marks[stem] = _instrument(path.read_text(), stem)
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


def main() -> None:
    import torch

    from phys_autodiff_tpu_torch import GridSpec, PhysWeights
    from phys_autodiff_tpu_torch.kernels import _build
    from phys_autodiff_tpu_torch.kernels import fit as kfit
    from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
    from phys_autodiff_tpu_torch.models import encoders, ngp
    from phys_autodiff_tpu_torch.models.fields import slice_times

    if not torch.cuda.is_available():
        raise SystemExit("phase_profile needs a CUDA card")
    lib, marks = _build_library()
    saved, _build._lib = _build._lib, lib
    try:
        dev = torch.device("cuda", 0)
        g = GridSpec(nx=128, ny=96, nz=96, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)
        ncfg = ngp.NGPFieldConfig()
        p = ngp.init_ngp_params(ncfg, seed=777, device=dev)
        enc = encoders.encode_grid_zcf(ncfg.encoding, p["tables"], g).contiguous()
        head = (enc, *(p[k].contiguous() for k in ("W1", "b1", "W2", "b2")))
        gen = torch.Generator(device=dev).manual_seed(0)
        target = kfit.pack_target(g, torch.randn(g.shape, device=dev, generator=gen),
                                  torch.randn((3,) + g.shape, device=dev, generator=gen))
        t = torch.full((), 0.25, device=dev)
        w, calls, nblk = PhysWeights(), 5, k5.num_blocks(g)
        runs = (("mega_ngp", lambda: k5.head_loss_and_grad(g, w, *head, slice_times(t, g.dt))),
                ("fit_ngp", lambda: kfit.ngp_fit_head_loss_and_grad(g, w, *head, t, target)))
        for stem, fn in runs:
            fn()
            torch.cuda.synchronize()
            getattr(lib, f"pat_phase_reset_{stem}")()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 64)()
            getattr(lib, f"pat_phase_read_{stem}")(counts)
            cycles = [counts[i] / calls / nblk for i in range(len(marks[stem]))]
            total = sum(cycles)
            print(f"phase_profile {stem}.cu (128x96x96, NGPFieldConfig(), {nblk} blocks): cycles a block by the "
                  f"barrier that ends each phase:")
            for line, c in zip(marks[stem], cycles):
                print(f"  {c:10.0f} ({100 * c / total:3.0f}%)  {line[:90]}")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        print(f"phase_profile card: {smi}")
    finally:
        _build._lib = saved


if __name__ == "__main__":
    main()
