"""Encoder registry: one interface over the encoded-field families (port of
phys_autodiff_tpu/models/encoders.py).

The encoded-field model (models/ngp.py) and its training step only consume
an [..., out_dim] encoding; this module maps a config TYPE to its
implementation. Built-in families:

  * HashEncodingConfig (models/hash_encoder.py): hash / dense corner-lattice
    tables, parameters = the tables.
  * FourierEncodingConfig (models/fourier.py): axis-separable positional
    features, no parameters (an empty "tables" tensor).

`register_family` plugs in another family: its `encode_grid_zcf` must be
differentiable by autograd in its parameters (the NGP backward kernel pulls
its encoder cotangent back through it). `encode_grid_zcf_rows` encodes a
subset of the z rows (a shard's rows and halo rows: the sharded NGP step
and fit encode only those, parallel/sharded.py, kernels/mega_ngp.py,
kernels/fit.py); `fast=True` takes a family's bf16-tier encode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from phys_autodiff_tpu_torch.models import fourier as _fourier
from phys_autodiff_tpu_torch.models import hash_encoder as _hash
from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig

__all__ = [
    "HashEncodingConfig",
    "FourierEncodingConfig",
    "EncoderFamily",
    "register_family",
    "registered_families",
    "family_of",
    "out_dim",
    "init_params",
    "schedule_meta",
    "encode",
    "encode_grid",
    "encode_grid_zcf",
    "encode_grid_zcf_rows",
]


@dataclasses.dataclass(frozen=True)
class EncoderFamily:
    """The per-family implementation table. Every callable takes the config
    first and the family's parameters second (parameter-free families take
    the device from their empty tensor):

      init_params(cfg, seed, device) -> the model's "tables" (an EMPTY
        tensor, not None, for parameter-free families)
      schedule_meta(cfg) -> checkpoint-fingerprint entries (keys unique to
        the family, so a cross-family restore is refused)
      encode(cfg, params, coords, allow_large) -> [..., out_dim] for
        coords [..., 3] in [0, 1]
      encode_grid(cfg, params, g) -> [nz, ny, nx, out_dim]
      encode_grid_zcf(cfg, params, g) -> [nz, out_dim, ny, nx]
      encode_grid_zcf_fast (optional) -> the same at the bf16 tier: within
        the tier's 5e-2 of the exact encode, forward and pull-back (the hash
        family rounds its resampling matmuls' operands to bf16). A family
        without one (Fourier: no matmuls to relax) serves both tiers with
        its exact encode, bit for bit.
      encode_grid_zcf_rows(cfg, params, g, rows) -> [len(rows), out_dim,
        ny, nx]: encode_grid_zcf at the given global z rows (an integer
        tensor), each row the matching full row; the shard-local encoder of
        the sharded step
      encode_grid_zcf_rows_fast (optional) -> the same at the bf16 tier,
        each row the matching encode_grid_zcf_fast row
    """

    name: str
    init_params: Callable[[Any, int, Any], Any]
    schedule_meta: Callable[[Any], dict]
    encode: Callable[..., Any]
    encode_grid: Callable[[Any, Any, Any], Any]
    encode_grid_zcf: Callable[[Any, Any, Any], Any]
    encode_grid_zcf_fast: Callable[[Any, Any, Any], Any] | None = None
    encode_grid_zcf_rows: Callable[[Any, Any, Any, Any], Any] | None = None
    encode_grid_zcf_rows_fast: Callable[[Any, Any, Any, Any], Any] | None = None


_REGISTRY: dict[type, EncoderFamily] = {}


def register_family(cfg_type: type, family: EncoderFamily) -> None:
    """Register an encoder family for a config type (a frozen dataclass
    exposing `out_dim`)."""
    if not isinstance(cfg_type, type):
        raise TypeError(f"cfg_type must be a type, got {cfg_type!r}")
    prior = _REGISTRY.get(cfg_type)
    if prior is not None and prior.name != family.name:
        raise ValueError(f"{cfg_type.__name__} already registered as {prior.name!r}")
    if not hasattr(cfg_type, "out_dim"):
        raise TypeError(f"{cfg_type.__name__} must expose out_dim")
    _REGISTRY[cfg_type] = family


def registered_families() -> list[type]:
    """The registered encoder-config types, in registration order."""
    return list(_REGISTRY)


def family_of(cfg) -> EncoderFamily:
    fam = _REGISTRY.get(type(cfg))
    if fam is None:
        for t, f in _REGISTRY.items():
            if isinstance(cfg, t):
                return f
        raise TypeError(
            f"unknown encoding config type: {type(cfg)!r} "
            f"(known: {[t.__name__ for t in _REGISTRY]}; see register_family)"
        )
    return fam


def out_dim(cfg) -> int:
    family_of(cfg)
    return cfg.out_dim


def init_params(cfg, seed: int = 0, device="cuda"):
    return family_of(cfg).init_params(cfg, seed, device)


def schedule_meta(cfg) -> dict:
    return family_of(cfg).schedule_meta(cfg)


def encode(cfg, params, coords, *, allow_large: bool = False):
    """Pointwise: coords [..., 3] in [0, 1] -> [..., out_dim]."""
    return family_of(cfg).encode(cfg, params, coords, allow_large)


def encode_grid(cfg, params, g):
    """Regular grid -> [nz, ny, nx, out_dim] (channels last)."""
    return family_of(cfg).encode_grid(cfg, params, g)


def encode_grid_zcf(cfg, params, g, *, fast: bool = False):
    """Regular grid -> [nz, out_dim, ny, nx] (z-major channel-first, the
    NGP backward kernel's input layout). fast=True takes the family's
    reduced-precision encode for the bf16-tier kernels where it registers
    one (encode_grid_zcf_fast), else the exact encode."""
    fam = family_of(cfg)
    if fast and fam.encode_grid_zcf_fast is not None:
        return fam.encode_grid_zcf_fast(cfg, params, g)
    return fam.encode_grid_zcf(cfg, params, g)


def encode_grid_zcf_rows(cfg, params, g, rows, *, fast: bool = False):
    """encode_grid_zcf restricted to the given global z rows (an integer
    tensor) -> [len(rows), out_dim, ny, nx], each row the matching
    encode_grid_zcf row (under fast=True the matching fast row, where the
    family registers a fast variant). A family without a row encoder
    raises."""
    fam = family_of(cfg)
    if fast and fam.encode_grid_zcf_rows_fast is not None:
        return fam.encode_grid_zcf_rows_fast(cfg, params, g, rows)
    if fam.encode_grid_zcf_rows is None:
        raise NotImplementedError(f"encoder family {fam.name!r} registers no encode_grid_zcf_rows")
    return fam.encode_grid_zcf_rows(cfg, params, g, rows)


register_family(
    HashEncodingConfig,
    EncoderFamily(
        name="hash",
        init_params=lambda cfg, seed, device: _hash.init_hash_params(cfg, seed=seed, device=device),
        schedule_meta=_hash.schedule_meta,
        encode=lambda cfg, params, coords, allow_large: _hash.encode(
            cfg, params, coords, allow_large=allow_large
        ),
        encode_grid=_hash.encode_grid,
        encode_grid_zcf=_hash.encode_grid_zcf,
        encode_grid_zcf_fast=lambda cfg, params, g: _hash.encode_grid_zcf(cfg, params, g, fast=True),
        encode_grid_zcf_rows=_hash.encode_grid_zcf_rows,
        encode_grid_zcf_rows_fast=lambda cfg, params, g, rows: _hash.encode_grid_zcf_rows(
            cfg, params, g, rows, fast=True
        ),
    ),
)

register_family(
    FourierEncodingConfig,
    EncoderFamily(
        name="fourier",
        init_params=lambda cfg, seed, device: _fourier.init_params(cfg, seed=seed, device=device),
        schedule_meta=_fourier.schedule_meta,
        encode=lambda cfg, params, coords, allow_large: _fourier.encode(cfg, coords),
        encode_grid=lambda cfg, params, g: _fourier.encode_grid(cfg, g, params.device),
        encode_grid_zcf=lambda cfg, params, g: _fourier.encode_grid_zcf(cfg, g, params.device),
        encode_grid_zcf_rows=lambda cfg, params, g, rows: _fourier.encode_grid_zcf_rows(cfg, g, rows, params.device),
    ),
)
