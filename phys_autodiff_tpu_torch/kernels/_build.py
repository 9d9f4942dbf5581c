"""Build, load and launch-check the port's CUDA kernels.

This takes the place of Pallas's compile step. Each csrc/*.cu is compiled
by its own nvcc process, all started together, and one nvcc call links the
objects into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o libpat_kernels_<hash>.so *.o

The library lands in build/phys_autodiff_tpu_torch/ at the repository root,
keyed by a hash of the sources (written to a temp file, then os.replace'd,
so a concurrent process never loads a half-written file), and is loaded with
ctypes. The compilers' output (ptxas register/shared-memory report) is kept
beside it as build_<hash>.log.

Each C entry point returns cudaGetLastError() after its launches; `check`
raises when it is not cudaSuccess, because a refused launch never runs and
a later synchronize does not report it.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from phys_autodiff_tpu_torch.utils import checks

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "phys_autodiff_tpu_torch"
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

#: One launch counter per kernel, bumped by each wrapper where it launches.
#: The bf16-tier kernels count apart from the f32 ones ("mlp bf16", ...).
LAUNCHES = {"residuals": 0, "mlp": 0, "mega": 0, "mega_bwd": 0, "mega_ngp": 0, "fit": 0, "fit_ngp": 0,
            "transport": 0, "transport_pre": 0, "probe": 0, "mlp bf16": 0, "mlp bf16x3": 0, "mega bf16": 0,
            "mega_bwd bf16": 0, "fit bf16": 0, "mega_ngp bf16": 0, "mega_ngp f32_fastbwd": 0, "fit_ngp bf16": 0,
            "residuals bf16": 0, "residuals mixed_out": 0,
            # the shard-local builds (a shard's rows of the global grid)
            "mega_bwd shard": 0, "mega_bwd bf16 shard": 0, "mega_ngp shard": 0, "mega_ngp bf16 shard": 0,
            "mega_ngp f32_fastbwd shard": 0, "fit shard": 0, "fit bf16 shard": 0, "fit_ngp shard": 0,
            "fit_ngp bf16 shard": 0,
            # K8's slab form (a rank's planes with one halo plane a side)
            "transport slab": 0,
            # the hash grid encoder (csrc/hash_encode.cu): its forward, and
            # its pull-back entry (two kernels); the bf16 tiers' fast encode
            "hash_encode": 0, "hash_encode pullback": 0, "hash_encode bf16": 0, "hash_encode bf16 pullback": 0}

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C signatures of the entry points (all return cudaError_t as int).
_SIGNATURES = {
    # 12 field channel pointers (PACKED_ORDER), 4 output channel pointers,
    # tile-partials scratch, nx, ny, nz, periodic, upwind, mode,
    # inv2dt, inv2hx, inv2hy, inv2hz, scale_sigma, scale_u, stream
    "pat_residuals": [P] * 12 + [P] * 4 + [P] + [I] * 6 + [F] * 6 + [P],
    # tile partials, ntiles, nz, parts [2, nz], loss [2], w_sigma, w_u, inv_n, stream
    "pat_partials_finalize": [P, I, I, P, P, F, F, F, P],
    # AB, CD, W2T, b2, sigma out, u out, nx, ny, nz, H, S, nblk, stream
    "pat_mlp_fields": [P] * 6 + [I] * 6 + [P],
    # AB, CD, W2T, b2, tile partials, nx, ny, nz, H, nblk, periodic, upwind,
    # inv2dt, inv2hx, inv2hy, inv2hz, stream
    "pat_mega_partials": [P, P, P, P, P] + [I] * 7 + [F] * 4 + [P],
    # AB, CD, W2T, b2, tile partials, g and t-slice scratch, dAB / dCD /
    # dW2T / db2 partials, dAB, dCD, dW2T, db2, nx, ny, nz, z0, nz_local,
    # H, nsub, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz,
    # scale_sigma, scale_u, stream
    "pat_mega_bwd": [P] * 15 + [I] * 9 + [F] * 6 + [P],
    # enc, W1c, tb1, ts, W2, b2, fields and g scratch, tile partials, dW1c /
    # (db1, dtw1, dW2) / db2 partials, dEnc (or null), dW1c, (db1, dtw1,
    # dW2), db2, nx, ny, nz, z0, nz_local, LF, H, nblk, periodic, upwind,
    # inv2dt, inv2hx, inv2hy, inv2hz, scale_sigma, scale_u, tier
    # (NGP_TIER_CODES), stream
    "pat_mega_ngp": [P] * 16 + [I] * 10 + [F] * 6 + [I, P],
    # AB, CD, W2T, b2, target, tile partials, dAB / dCD / dW2T / db2
    # partials, dAB, dCD, dW2T, db2, nx, ny, nz, H, nsub, scale_sigma,
    # scale_u, stream
    "pat_fit": [P] * 14 + [I] * 5 + [F] * 2 + [P],
    # enc, W1c, tb1, W2, b2, target, tile partials, dW1c / (db1, dW2) / db2
    # partials, dEnc (or null), dW1c, (db1, dW2), db2, nx, ny, nz, LF, H,
    # nblk, scale_sigma, scale_u, tier (NGP_TIER_CODES), stream
    "pat_ngp_fit": [P] * 14 + [I] * 6 + [F] * 2 + [I, P],
    # fields, u, out, C, nx, ny, nz, periodic, zc, sx, sy, sz, stream
    "pat_transport": [P] * 3 + [I] * 6 + [F] * 3 + [P],
    # fields_ext, u_ext, out, C, nx, ny, nz_local, periodic, zc, sx, sy, sz,
    # stream (the slab form: nz_local + 2 planes in, nz_local out)
    "pat_transport_slab": [P] * 3 + [I] * 6 + [F] * 3 + [P],
    # sigma, xp, xm, yp, ym, zp, zm, out, nx, ny, nz, periodic, zc, stream
    "pat_transport_pre": [P] * 8 + [I] * 5 + [P],
    # in, out, n, stream
    "pat_probe": [P, P, I, P],
    # the levels' corner pointers (a host array), L, meta, taps_i, taps_w,
    # enc out, K, ny, nx, fast, stream
    "pat_hash_encode": [P, I, P, P, P, P, I, I, I, I, P],
    # dEnc, meta, taps_i, taps_w, tiles_a, n_a, tiles_b, n_b, cptr, cidx,
    # cw, planes scratch, grad out, K, ny, nx, L, row_floats, kb (rows a
    # pass-A block), smem_a, fast, stream
    "pat_hash_encode_pullback": [P, P, P, P, P, I, P, I, P, P, P, P, P] + [I] * 8 + [P],
    # The bf16 tier (csrc/mlp_mma.cuh): the f32 entry points' arguments; K2's
    # last int before the stream is 1 for bf16x3.
    "pat_mlp_fields_bf16": [P] * 6 + [I] * 7 + [P],
    "pat_mega_partials_bf16": [P, P, P, P, P] + [I] * 7 + [F] * 4 + [P],
    "pat_mega_bwd_bf16": [P] * 15 + [I] * 9 + [F] * 6 + [P],
    "pat_fit_bf16": [P] * 14 + [I] * 5 + [F] * 2 + [P],
    # K1's bf16-I/O entry points (residuals only): 12 field channel pointers
    # (bf16, or float32 for mixed_out), 4 bf16 output channel pointers, nx,
    # ny, nz, periodic, upwind, inv2dt, inv2hx, inv2hy, inv2hz, stream
    "pat_residuals_bf16": [P] * 16 + [I] * 5 + [F] * 4 + [P],
    "pat_residuals_mixed_out": [P] * 16 + [I] * 5 + [F] * 4 + [P],
    # A [16, 16], B [16, 8] float32 in; D [16, 8] float32 and the packed
    # bf16 pairs of A [16, 8] uint32 out; stream (one m16n8k16 fragment)
    "pat_mma_check": [P] * 5,
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from torch's CUDA_HOME, then PATH, then /usr/local/cuda/bin."""
    from torch.utils import cpp_extension

    candidates = []
    if cpp_extension.CUDA_HOME:
        candidates.append(os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(NVCC_DEFAULT)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in torch's CUDA_HOME, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of phys_autodiff_tpu_torch "
        "need the CUDA toolkit to build"
    )


def build() -> Path:
    """Compile csrc/*.cu into the hashed library if it is not there yet;
    returns its path."""
    key = _source_hash()
    lib_path = BUILD_DIR / f"libpat_kernels_{key}.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log, failed = [], []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        jobs = []
        for src in sources():
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", os.path.join(objdir, src.stem + ".o"), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cmd, proc in jobs:
            out, err = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out + err)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
        if not failed:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *LINK_FLAGS, "-o", tmp, *(cmd[cmd.index("-o") + 1] for cmd, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    (BUILD_DIR / f"build_{key}.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.pat_error_string.argtypes = [ctypes.c_int]
        handle.pat_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, what: str, kernel: str | None = None, outputs=()) -> None:
    """Raise if a C entry point reported a CUDA error. A wrapper that names
    its `kernel` ("K3") and the tensors the launch wrote has them checked,
    under utils/checks.checked, as one primitive of that name."""
    if err != 0:
        msg = lib().pat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
    if kernel is not None and checks.active:
        checks.record_kernel(kernel, outputs)


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: The precision tiers each kernel runs, and the arithmetic it runs each
#: in. As in the JAX package, "f32_high" is the f32 arithmetic
#: (pallas/mlp.py:216, mega.py:347-351, mega_bwd.py:240, fit.py:83-90), and
#: so is "bf16x3" outside K2: K3, K4 and K6 run it as f32 operands at HIGHEST
#: precision. K1's f32 wrappers take the f32 names; its bf16-I/O tiers are
#: entry points of their own, as in the JAX package (BF16_ENTRY_POINTS).
#: The encoded-field (NGP) callers: "head" is the decode head of
#: models/ngp.py (the autograd path; models/ngp.py:87-129, 185-207), K5 the
#: NGP backward kernel (pallas/mega_ngp.py:96, 202-219: "f32_fastbwd" rounds
#: its backward's carried base and encoding rows), K7 the NGP fit kernel
#: (pallas/fit.py:410-527). Every f32 name is f32 arithmetic there but K5's
#: "f32_fastbwd".
TIERS = {
    "K1": {"f32": "f32", "f32_high": "f32", "bf16x3": "f32"},
    "K2": {"f32": "f32", "f32_high": "f32", "bf16": "bf16", "bf16x3": "bf16x3"},
    "K3": {"f32": "f32", "f32_high": "f32", "bf16": "bf16", "bf16x3": "f32"},
    "K4": {"f32": "f32", "f32_high": "f32", "bf16": "bf16", "bf16x3": "f32"},
    "K6": {"f32": "f32", "f32_high": "f32", "bf16": "bf16", "bf16x3": "f32"},
    "head": {"f32": "f32", "f32_high": "f32", "bf16x3": "f32", "f32_fastbwd": "f32", "bf16": "bf16"},
    "K5": {"f32": "f32", "f32_high": "f32", "bf16x3": "f32", "f32_fastbwd": "f32_fastbwd", "bf16": "bf16"},
    "K7": {"f32": "f32", "f32_high": "f32", "bf16x3": "f32", "f32_fastbwd": "f32", "bf16": "bf16"},
}

#: The code of each NGP kernel arithmetic in the C entry points' tier
#: argument (csrc/ngp_head.cuh TIER_*).
NGP_TIER_CODES = {"f32": 0, "bf16": 1, "f32_fastbwd": 2}

#: K1's bf16-I/O tiers, which are entry points of their own (kernels/residuals.py).
BF16_ENTRY_POINTS = "residuals_fused_packed_bf16 (bf16 in and out) or residuals_fused_packed_mixed_out (bf16 out)"


def check_precision(precision: str, kernel: str) -> str:
    """The arithmetic ("f32", "bf16", "bf16x3" or "f32_fastbwd") in which
    `kernel` (a key of TIERS) runs `precision`. A name the kernel does not
    take raises ValueError (K1's f32 wrappers given "bf16" name its bf16-I/O
    entry points)."""
    if precision in TIERS[kernel]:
        return TIERS[kernel][precision]
    if kernel == "K1" and precision == "bf16":
        raise ValueError(f"K1: the f32 wrappers take {', '.join(sorted(TIERS['K1']))}; for bf16 I/O call "
                         f"{BF16_ENTRY_POINTS}")
    raise ValueError(f"unknown precision {precision!r}")


def gate_top(fits) -> int:
    """The largest hidden width that a kernel's shared-memory gate
    `fits(h)` takes (the gates fall with h; every one holds at H = 1 and
    fails by H = 4096): the top that the gates' errors name."""
    return max(h for h in range(1, 4097) if fits(h))


def uses_kernel(*tensors) -> bool:
    """False for CPU tensors (the wrapper runs the plain version), True for
    CUDA tensors that the kernel takes; raises for anything else."""
    dev = tensors[0].device
    if dev.type == "cpu":
        if any(t.device != dev for t in tensors):
            raise ValueError("inputs lie on different devices")
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("inputs lie on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel inputs must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            # The differentiable wrappers launch from inside an
            # autograd.Function's forward, where grad mode is off; anything
            # else would hand back an output that autograd cannot follow.
            raise NotImplementedError(
                "this kernel wrapper has no backward: pass tensors that do "
                "not require grad, or call it under torch.no_grad()"
            )
    return True


def check_shape(t, shape, name: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")

