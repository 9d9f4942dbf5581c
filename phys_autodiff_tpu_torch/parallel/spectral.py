"""The distributed FFT Helmholtz projection and implicit diffusion: the pencil
decomposition over a ZMesh (port of phys_autodiff_tpu/parallel/spectral.py).

ops/projection.project_fft needs the whole 3-D spectrum, but a rank holds
only its z rows. The pencil (transpose) decomposition builds the spectrum
from two all-to-alls a solve:

    [nz/n, ny, nx]          rfft x, fft y      (x and y are whole on a rank)
      -> all_to_all (split y, concatenate z) -> [nz, ny/n, nx/2+1]
    fft z, the symbol, ifft z
      -> all_to_all (split z, concatenate y) -> [nz/n, ny, nx/2+1]
    ifft y, irfft x

Each all-to-all is one dist.all_to_all_single of the complex pencil, handed
over as its float32 view (torch.view_as_real: NCCL takes no complex
tensors). The divergence in and the pressure gradient out need only the
one-plane z halo (parallel/sharded.halo_extend_z_diff); local_divergence
and local_grad, the row stencils of the sharded Euler solver, take either
boundary. The FFTs are torch.fft: the JAX package runs them in XLA,
outside any Pallas kernel.

Everything here is differentiable across the ranks, as the JAX package's
shard_map is: the halo's backward returns each halo plane's cotangent to
its owner, and the all-to-all's backward is the same all-to-all of the
cotangents (the exchange is its own adjoint). Every rank must run the
backward, as it ran the forward; a loss is the sum of the ranks' parts.

The arithmetic is the single-device projector's mode for mode (the same
symbol, the same Nyquist masking); the factored per-axis FFTs evaluate in
another order than the fused rfftn, so the two agree to float rounding
(about 1e-6 relative), not to the bit. Periodic grids only, and nz and ny
must divide over the ranks: anything else raises before any collective.

Every function takes and returns this rank's rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from phys_autodiff_tpu_torch.ops.projection import _central_symbols
from phys_autodiff_tpu_torch.ops.stencil import central_diff, inv2h_f32
from phys_autodiff_tpu_torch.parallel.mesh import ZMesh
from phys_autodiff_tpu_torch.parallel.sharded import halo_extend_z_diff
from phys_autodiff_tpu_torch.utils.config import GridSpec


def _check(g: GridSpec, mesh: ZMesh, what: str) -> None:
    """The pencil's preconditions, the same on every rank (so that a bad
    call raises everywhere before the first collective)."""
    if not g.periodic:
        raise ValueError(f"the spectral {what} requires periodic boundaries")
    if g.nz % mesh.size or g.ny % mesh.size:
        raise ValueError(f"the spectral {what} needs nz and ny divisible by the {mesh.size} ranks, got {g.shape}")


def _exchange(mesh: ZMesh, send: torch.Tensor) -> torch.Tensor:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send.contiguous(), group=mesh.group)
    return recv


class _AllToAll(torch.autograd.Function):
    """_exchange with its adjoint: the cotangent of block i of the result
    goes back to rank i, which is the same all-to-all of the cotangents."""

    @staticmethod
    def forward(ctx, mesh, send):
        ctx.mesh = mesh
        return _exchange(mesh, send)

    @staticmethod
    def backward(ctx, d_recv):
        return None, _exchange(ctx.mesh, d_recv)


def _all_to_all(mesh: ZMesh, x: torch.Tensor) -> torch.Tensor:
    """dist.all_to_all_single of a complex [n, ...] tensor: block j goes to
    rank j, block i of the result came from rank i. Differentiable."""
    return torch.view_as_complex(_AllToAll.apply(mesh, torch.view_as_real(x.contiguous()).contiguous()))


def _pencil_rfft3(mesh: ZMesh, f_local: torch.Tensor) -> torch.Tensor:
    """The forward 3-D rfft of a rank's rows [nz/n, ny, nx] as the spectrum
    pencil [nz, ny/n, nx/2+1], by one all-to-all."""
    n = mesh.size
    h = torch.fft.fft(torch.fft.rfft(f_local, dim=2), dim=1)
    nzl, ny, nxh = h.shape
    blocks = h.reshape(nzl, n, ny // n, nxh).transpose(0, 1)  # [n, nz/n, ny/n, nx/2+1], block j: y chunk j
    h = _all_to_all(mesh, blocks).reshape(n * nzl, ny // n, nxh)  # rank i's rows of this y chunk, in z order
    return torch.fft.fft(h, dim=0)


def _pencil_irfft3(mesh: ZMesh, h: torch.Tensor, nx: int) -> torch.Tensor:
    """The inverse of _pencil_rfft3: [nz, ny/n, nx/2+1] -> [nz/n, ny, nx]."""
    n = mesh.size
    h = torch.fft.ifft(h, dim=0)
    nz, nyl, nxh = h.shape
    blocks = h.reshape(n, nz // n, nyl, nxh)  # block j: rank j's z rows
    h = _all_to_all(mesh, blocks).transpose(0, 1).reshape(nz // n, n * nyl, nxh)  # y chunks in y order
    return torch.fft.irfft(torch.fft.ifft(h, dim=1), n=nx, dim=2)


def _slice_y(mesh: ZMesh, vec_b: torch.Tensor, ny_local: int) -> torch.Tensor:
    """This rank's y chunk [1, ny/n, 1] of a [1, ny, 1] spectral vector."""
    return vec_b.reshape(-1)[mesh.rank * ny_local:(mesh.rank + 1) * ny_local][None, :, None]


def _halo_zdiff(mesh: ZMesh, f_local: torch.Tensor, inv2h, periodic: bool = True) -> torch.Tensor:
    """The central z difference of a rank's rows [..., nz/n, ny, nx] against
    the exchanged one-plane halo (the grid's z rule at its edges)."""
    ax = f_local.ndim - 3
    ext = halo_extend_z_diff(mesh, f_local, periodic, ax)
    n = f_local.shape[ax]
    return (ext.narrow(ax, 2, n) - ext.narrow(ax, 0, n)) * float(inv2h)


def local_divergence(g: GridSpec, mesh: ZMesh, u_local: torch.Tensor) -> torch.Tensor:
    """ops.diagnostics.divergence of a rank's rows, either boundary: x and y
    local (ops.stencil.central_diff, JAX's _local_xydiff), z against the
    halo; the single-device values to the bit."""
    per = g.periodic
    return (central_diff(u_local[0], 2, inv2h_f32(g.hx), per) + central_diff(u_local[1], 1, inv2h_f32(g.hy), per)
            + _halo_zdiff(mesh, u_local[2], inv2h_f32(g.hz), per))


def local_grad(g: GridSpec, mesh: ZMesh, p_local: torch.Tensor) -> torch.Tensor:
    """ops.projection.grad of a rank's rows p [nz/n, ny, nx], either
    boundary: [3, nz/n, ny, nx]."""
    per = g.periodic
    return torch.stack([central_diff(p_local, 2, inv2h_f32(g.hx), per),
                        central_diff(p_local, 1, inv2h_f32(g.hy), per),
                        _halo_zdiff(mesh, p_local, inv2h_f32(g.hz), per)])


def shard_local_project_fft(g: GridSpec, mesh: ZMesh):
    """The per-rank projection: project(u_local [3, nz/n, ny, nx]) -> the
    same shape. A call exchanges two halos (the divergence's uz, the
    pressure's z gradient) and makes two all-to-alls."""
    _check(g, mesh, "projection")
    ny_local = g.ny // mesh.size

    def project(u_local: torch.Tensor) -> torch.Tensor:
        sz, sy, sx = _central_symbols(g, u_local.device)
        d = local_divergence(g, mesh, u_local)
        h = _pencil_rfft3(mesh, d)
        sy_loc = _slice_y(mesh, sy, ny_local)
        lap = -(sx * sx + sy_loc * sy_loc + sz * sz)
        nonzero = lap != 0.0
        h = torch.where(nonzero, h / torch.where(nonzero, lap, torch.ones_like(lap)),
                        torch.zeros((), dtype=h.dtype, device=h.device))
        p = _pencil_irfft3(mesh, h, g.nx).to(u_local.dtype)
        return u_local - local_grad(g, mesh, p)

    return project


def _compact_symbols_1d(g: GridSpec, device):
    """The compact Laplacian's 1-D symbols 4 sin^2(pi k / n) / h^2 per axis
    (float64, cast to float32): ops.diffusion's symbol is their sum."""

    def s_of(k, n, h):
        s = np.sin(np.pi * k / n) / h
        return torch.as_tensor((4.0 * s * s).astype(np.float32), device=device)

    return (s_of(np.fft.fftfreq(g.nz) * g.nz, g.nz, g.hz), s_of(np.fft.fftfreq(g.ny) * g.ny, g.ny, g.hy),
            s_of(np.fft.rfftfreq(g.nx) * g.nx, g.nx, g.hx))


def shard_local_diffuse_fft(g: GridSpec, mesh: ZMesh, c: float, dt: float):
    """The per-rank implicit diffusion (ops.diffusion.diffuse_fft's exact
    periodic solve, pencil-decomposed): diffuse(f_local [..., nz/n, ny, nx])
    -> the same shape; a leading axis (the velocity's three components) is
    solved one scalar at a time, two all-to-alls each."""
    _check(g, mesh, "diffusion")
    ny_local = g.ny // mesh.size
    cdt = float(np.float32(c) * np.float32(dt))

    def diffuse_scalar(f_local: torch.Tensor) -> torch.Tensor:
        sz, sy, sx = _compact_symbols_1d(g, f_local.device)
        lam = sz[:, None, None] + _slice_y(mesh, sy, ny_local) + sx[None, None, :]
        h = _pencil_rfft3(mesh, f_local) / (1.0 + cdt * lam)
        return _pencil_irfft3(mesh, h, g.nx).to(f_local.dtype)

    def diffuse(f_local: torch.Tensor) -> torch.Tensor:
        if f_local.ndim == 3:
            return diffuse_scalar(f_local)
        if f_local.ndim != 4:
            raise ValueError(f"expected [nz/n, ny, nx] or [C, nz/n, ny, nx], got {tuple(f_local.shape)}")
        return torch.stack([diffuse_scalar(f_local[i]) for i in range(f_local.shape[0])])

    return diffuse


def project_fft_sharded(g: GridSpec, u_local: torch.Tensor, mesh: ZMesh) -> torch.Tensor:
    """The distributed projection of this rank's rows u_local [3, nz/n, ny,
    nx]: the single-device ops.projection.project_fft's rows to float
    rounding."""
    project = shard_local_project_fft(g, mesh)
    nzl = g.nz // mesh.size
    if tuple(u_local.shape) != (3, nzl, g.ny, g.nx):
        raise ValueError(f"expected this rank's rows {(3, nzl, g.ny, g.nx)}, got {tuple(u_local.shape)}")
    return project(u_local)
