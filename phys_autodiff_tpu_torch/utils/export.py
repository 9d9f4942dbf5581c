"""Field snapshot export: .npz series and legacy VTK for ParaView (the
port's own copy of phys_autodiff_tpu/utils/export.py, which imports no jax:
the two packages read each other's files).

Formats:

  * npz: one atomic .npz per snapshot (the same atomic-replace discipline as
    train/checkpoint.py: a crash never leaves a torn file) with the
    GridSpec embedded as JSON, so a snapshot is self-describing.
  * VTK legacy STRUCTURED_POINTS, binary: the simplest format every
    ParaView/VisIt build reads. The [nz, ny, nx] C-order layout IS VTK's
    point order (x fastest, z slowest: the reference's flat index
    idx = (z*ny + y)*nx + x, src/phys_cpu.cpp:17-19), so export is a header
    plus one big-endian byte swap, no transpose.

Everything here is host-side and NumPy-only: fetch tensors from the card
(`.cpu().numpy()`) before handing them over.
"""

from __future__ import annotations

import json
import os
from typing import Mapping

import numpy as np

from phys_autodiff_tpu_torch.utils.config import GridSpec


def _grid_meta(g: GridSpec) -> dict:
    return {
        "nx": g.nx, "ny": g.ny, "nz": g.nz,
        "hx": g.hx, "hy": g.hy, "hz": g.hz,
        "dt": g.dt, "periodic": g.periodic, "scheme": g.scheme,
    }


def save_fields_npz(
    path: str,
    g: GridSpec,
    fields: Mapping[str, np.ndarray],
    t: float | None = None,
) -> str:
    """Write a self-describing snapshot archive: each field under its own
    key plus a __grid__ JSON entry (and the snapshot time when given).
    Returns the final path (".npz" appended if missing)."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)
    meta = _grid_meta(g)
    if t is not None:
        meta["t"] = float(t)
    arrays = {k: np.asarray(v) for k, v in fields.items()}
    for k, v in arrays.items():
        if v.shape[-3:] != g.shape:
            raise ValueError(f"field {k!r} has shape {v.shape}; its last three axes must be {g.shape}")
    tmp = npz_path + ".tmp.npz"
    np.savez(
        tmp,
        __grid__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays,
    )
    os.replace(tmp, npz_path)
    return npz_path


def load_fields_npz(path: str):
    """(fields dict, grid-meta dict) from a save_fields_npz archive."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with np.load(npz_path) as data:
        meta = json.loads(bytes(data["__grid__"].tobytes()).decode())
        fields = {k: data[k] for k in data.files if k != "__grid__"}
    return fields, meta


def write_vtk(
    path: str,
    g: GridSpec,
    fields: Mapping[str, np.ndarray],
    title: str = "phys_autodiff_tpu snapshot",
) -> str:
    """Write scalars ([nz, ny, nx]) and vectors ([3, nz, ny, nx]) to one
    legacy binary VTK STRUCTURED_POINTS file (ParaView/VisIt-readable).
    Data is converted to big-endian float32 as the legacy format requires.
    Returns the final path (".vtk" appended if missing)."""
    vtk_path = path if path.endswith(".vtk") else path + ".vtk"
    os.makedirs(os.path.dirname(os.path.abspath(vtk_path)), exist_ok=True)
    n = g.num_cells
    be = np.dtype(">f4")
    chunks: list[bytes] = []
    chunks.append(
        (
            f"# vtk DataFile Version 3.0\n{title}\nBINARY\n"
            "DATASET STRUCTURED_POINTS\n"
            f"DIMENSIONS {g.nx} {g.ny} {g.nz}\n"
            "ORIGIN 0 0 0\n"
            f"SPACING {g.hx} {g.hy} {g.hz}\n"
            f"POINT_DATA {n}\n"
        ).encode()
    )
    for name, arr in fields.items():
        a = np.asarray(arr, dtype=np.float32)
        if " " in name:
            raise ValueError(f"VTK array names cannot contain spaces: {name!r}")
        if a.shape == g.shape:
            chunks.append(
                f"SCALARS {name} float 1\nLOOKUP_TABLE default\n".encode()
            )
            # [nz, ny, nx] C-order ravel == VTK x-fastest point order
            chunks.append(np.ascontiguousarray(a, dtype=be).tobytes())
        elif a.shape == (3,) + g.shape:
            chunks.append(f"VECTORS {name} float\n".encode())
            inter = np.moveaxis(a, 0, -1)  # [nz, ny, nx, 3] interleaved
            chunks.append(np.ascontiguousarray(inter, dtype=be).tobytes())
        else:
            raise ValueError(
                f"field {name!r} has shape {a.shape}; expected {g.shape} "
                f"(scalar) or {(3,) + g.shape} (vector)"
            )
        chunks.append(b"\n")
    tmp = vtk_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(chunks))
    os.replace(tmp, vtk_path)
    return vtk_path


def write_vtk_series(
    prefix: str,
    g: GridSpec,
    frames,
    dt_frame: float = 1.0,
) -> list[str]:
    """Write an indexed VTK series <prefix>_0000.vtk, ... plus a ParaView
    .vtk.series JSON index (time-aware playback). `frames` is an iterable
    of field dicts (see write_vtk). Returns the written .vtk paths."""
    paths = []
    entries = []
    for i, fields in enumerate(frames):
        p = write_vtk(f"{prefix}_{i:04d}.vtk", g, fields)
        paths.append(p)
        entries.append(
            {"name": os.path.basename(p), "time": i * float(dt_frame)}
        )
    series = {"file-series-version": "1.0", "files": entries}
    tmp = prefix + ".vtk.series.tmp"
    with open(tmp, "w") as f:
        json.dump(series, f, indent=1)
    os.replace(tmp, prefix + ".vtk.series")
    return paths
