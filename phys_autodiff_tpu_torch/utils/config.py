"""Configuration dataclasses (the port's own copy of
phys_autodiff_tpu/utils/config.py, without its jax-only `dot_precision`).

These mirror the reference's plain config structs 1:1 in field names and
defaults (reference: include/phys.h:8-18, include/mlp_grid.h:13-31) so that a
user of the reference finds the same knobs here.
"""

from __future__ import annotations

import dataclasses
import enum


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Dense 3D grid description (reference: include/phys.h:8-13).

    nx/ny/nz: grid extents; hx/hy/hz: cell sizes; dt: time-step used for the
    central time difference; periodic: periodic wrap vs clamp boundaries.

    scheme selects the advection-term discretization (the reference's
    planned-but-unbuilt M4 switch, REQUIREMENT.md:131-134):
      "central" — (f[i+1] - f[i-1]) / 2h everywhere (reference behavior)
      "upwind"  — first-order one-sided differences for the advection terms
                  u.grad(sigma) and (u.grad)u, selected by the local
                  velocity sign; time derivative and div(u) stay central.
    All arms (f64 oracle, staged XLA, fused Pallas, slab gradient) honor it,
    so cross-arm comparisons stay consistent (REQUIREMENT.md:219).
    """

    nx: int = 0
    ny: int = 0
    nz: int = 0
    hx: float = 1.0
    hy: float = 1.0
    hz: float = 1.0
    dt: float = 1.0
    periodic: bool = True
    scheme: str = "central"  # "central" | "upwind"

    def __post_init__(self):
        if self.scheme not in ("central", "upwind"):
            # every arm selects upwind by exact string match, so a typo
            # would silently run central differencing in ALL arms (and
            # cross-arm parity tests would still pass) — fail loudly here
            raise ValueError(
                f"unknown scheme {self.scheme!r}: expected 'central' or 'upwind'"
            )

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def shape(self) -> tuple[int, int, int]:
        """Array shape [nz, ny, nx] — x fastest, matching the reference's
        flat index (z*ny + y)*nx + x under C-order reshape."""
        return (self.nz, self.ny, self.nx)


@dataclasses.dataclass(frozen=True)
class PhysWeights:
    """Loss weights (reference: include/phys.h:15-18)."""

    w_sigma: float = 1.0
    w_u: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLPDims:
    """2-layer MLP dimensions (reference: include/mlp_grid.h:13-17).

    In=4 space-time coords, Out=4 channels [sigma, ux, uy, uz].
    """

    In: int = 4
    H: int = 64
    Out: int = 4


class CoordNorm(enum.Enum):
    """Coordinate normalization mode (reference: include/mlp_grid.h:26)."""

    ZeroToOne = "zero_to_one"
    MinusOneToOne = "minus_one_to_one"


@dataclasses.dataclass(frozen=True)
class MLPGridConfig:
    """MLP-over-grid config (reference: include/mlp_grid.h:28-31)."""

    dims: MLPDims = dataclasses.field(default_factory=MLPDims)
    norm: CoordNorm = CoordNorm.MinusOneToOne
