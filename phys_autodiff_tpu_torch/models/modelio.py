"""Self-describing model checkpoints: grid + model config + params in one
atomically written .npz (port of phys_autodiff_tpu/models/modelio.py).

`save_model` embeds the GridSpec and the full model config in the manifest
of a train/checkpoint.py npz, and `load_model` rebuilds (GridSpec, config,
params) from the file alone. The format string is the JAX package's, and
the tree, the config and the encoding-schedule fingerprint
(ngp.checkpoint_meta) are written as it writes them, so a checkpoint
crosses between the two packages both ways; a schedule mismatch between
the writer and the reader still fails loudly.

Covers the built-in families (coordinate MLP, NGP over the hash, Fourier
or K-Planes encoding). Third-party encoder families registered through models/encoders
own their config classes and persist them with
train/checkpoint.save_npz(meta=...) themselves.
"""

from __future__ import annotations

import dataclasses

from phys_autodiff_tpu_torch.models.fourier import FourierEncodingConfig
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.models.kplanes import KPlanesConfig
from phys_autodiff_tpu_torch.models.ngp import NGPFieldConfig, checkpoint_meta
from phys_autodiff_tpu_torch.train import checkpoint
from phys_autodiff_tpu_torch.utils.config import CoordNorm, GridSpec, MLPDims, MLPGridConfig

_FORMAT = "phys_autodiff_tpu.model/1"


def _grid_meta(g: GridSpec) -> dict:
    return {
        "nx": g.nx, "ny": g.ny, "nz": g.nz,
        "hx": g.hx, "hy": g.hy, "hz": g.hz,
        "dt": g.dt, "periodic": g.periodic, "scheme": g.scheme,
    }


def grid_from_meta(meta: dict) -> GridSpec:
    return GridSpec(**meta)


def config_meta(model_cfg) -> dict:
    """JSON-safe description of a built-in model config."""
    if isinstance(model_cfg, MLPGridConfig):
        return {"family": "mlp", "dims": dataclasses.asdict(model_cfg.dims), "norm": model_cfg.norm.value}
    if isinstance(model_cfg, NGPFieldConfig):
        enc = model_cfg.encoding
        if isinstance(enc, HashEncodingConfig):
            enc_meta = {"kind": "hash", **dataclasses.asdict(enc)}
        elif isinstance(enc, FourierEncodingConfig):
            enc_meta = {"kind": "fourier", **dataclasses.asdict(enc)}
        elif isinstance(enc, KPlanesConfig):
            enc_meta = {"kind": "kplanes", **dataclasses.asdict(enc), "multipliers": [int(m) for m in enc.multipliers]}
        else:
            raise TypeError(
                f"cannot serialize third-party encoding config {type(enc).__name__}; persist it with "
                "train.checkpoint.save_npz(meta=...) yourself"
            )
        return {"family": "ngp", "hidden": model_cfg.hidden, "out": model_cfg.out, "encoding": enc_meta}
    raise TypeError(f"unknown model config type {type(model_cfg).__name__}")


def config_from_meta(meta: dict):
    """Inverse of config_meta."""
    family = meta["family"]
    if family == "mlp":
        return MLPGridConfig(dims=MLPDims(**meta["dims"]), norm=CoordNorm(meta["norm"]))
    if family == "ngp":
        enc_meta = dict(meta["encoding"])
        kind = enc_meta.pop("kind")
        if kind == "hash":
            enc = HashEncodingConfig(**enc_meta)
        elif kind == "fourier":
            enc = FourierEncodingConfig(**enc_meta)
        elif kind == "kplanes":
            enc = KPlanesConfig(**{**enc_meta, "multipliers": tuple(enc_meta["multipliers"])})
        else:
            raise ValueError(f"unknown encoding kind {kind!r}")
        return NGPFieldConfig(encoding=enc, hidden=meta["hidden"], out=meta["out"])
    raise ValueError(f"unknown model family {family!r}")


def _schedule_meta(model_cfg) -> dict:
    """The family's restore-validation fingerprint (empty for the MLP)."""
    return {} if isinstance(model_cfg, MLPGridConfig) else checkpoint_meta(model_cfg)


def save_model(path: str, g: GridSpec, model_cfg, params) -> None:
    """One self-describing checkpoint: params tree + grid + config."""
    meta = {"format": _FORMAT, "grid": _grid_meta(g), "model": config_meta(model_cfg), **_schedule_meta(model_cfg)}
    checkpoint.save_npz(path, params, meta=meta)


def load_model(path: str, device="cuda"):
    """(GridSpec, model config, params) from a save_model checkpoint, the
    params on `device`."""
    manifest = checkpoint.read_manifest(path)
    if manifest is None or "meta" not in manifest:
        raise ValueError(
            f"{path} has no '{_FORMAT}' format manifest: not a save_model checkpoint (use "
            "train.checkpoint.restore_npz with an explicit `like`)"
        )
    meta = manifest["meta"]
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path} manifest format {meta.get('format')!r} != {_FORMAT!r}")
    g = grid_from_meta(meta["grid"])
    model_cfg = config_from_meta(meta["model"])
    from phys_autodiff_tpu_torch.train.fit_field import init_any

    like = init_any(model_cfg, seed=0, device=device)
    params = checkpoint.restore_npz(path, like, expect_meta=meta)
    return g, model_cfg, params
