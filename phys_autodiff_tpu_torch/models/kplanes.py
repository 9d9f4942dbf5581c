"""K-Planes: a space-time field factorised into six planes (Fridovich-Keil,
Meanti, Warburg, Recht, Kanazawa, CVPR 2023, arXiv:2301.10241; the hybrid
model of github.com/sarafridov/K-Planes).

Six planes xy, xz, xt, yz, yt, zt (every pair of x, y, z, t, in
itertools.combinations order) of F features at each of several scales:
spatial resolution base x multiplier a side, time resolution unscaled. The
feature of scale l at (x, y, z, t) is the product, in that plane order, of
the six planes' bilinear samples; the scales concatenate, so the encoding
has out_dim = scales x F channels. A plane (a, b) is stored [F, res_b,
res_a], as the published code's grid_sample reads it (a, the first axis of
the pair, is the sample's x). Parameters: {"s<l>": {"xy": ..., "zt": ...}}.

Sampling is grid_sample(align_corners=True, padding_mode="border"): a
spatial node at unit coordinate u (i / (n - 1), float32) has c = 2u - 1,
and t in [0, 1] has c = 2t - 1; the position on an axis of r points is
((c + 1) / 2) (r - 1), clamped to [0, r - 1], all in float32. A lerp is
(1 - w) a + w b, first along the plane's a axis, then along b.

The encoding depends on t through the xt, yt and zt planes, so the field's
three slices t - dt, t, t + dt have three encodings (`encode_grid_zcf_slices`,
[S, nz, LF, ny, nx]) and the decode head takes the features alone, with no
time column (models/ngp.py). On a grid the encoding is separable: each
plane is sampled once at its axes' nodes (the "node tables": XY [LF, ny,
nx], XZ [LF, nz, nx], YZ [LF, nz, ny], and each slice's XT [LF, nx], YT
[LF, ny], ZT [LF, nz]) and a cell's feature is
((((XY XZ) XT) YZ) YT) ZT, the published product order.

For CPU tables the encoding runs these plain ops, pulled back by autograd;
for CUDA tables csrc/kplanes_encode.cu (`_EncodeKernel`): the same node
tables and products, the same bits, and a pull-back of fixed-order sums
with no atomics, the same bits every run.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils.timing import annotate

#: The planes in the published order (itertools.combinations of x, y, z, t)
#: and the two axes of each: (a, b), a the sample's first coordinate.
PLANES = ("xy", "xz", "xt", "yz", "yt", "zt")
_AXES = {"xy": ("x", "y"), "xz": ("x", "z"), "xt": ("x", "t"), "yz": ("y", "z"), "yt": ("y", "t"),
         "zt": ("z", "t")}
#: The most scales the kernels take.
MAX_SCALES = 8
#: The published init: planes containing t 1, the others U(0.1, 0.5).
INIT_LOW, INIT_HIGH = 0.1, 0.5


@dataclasses.dataclass(frozen=True)
class KPlanesConfig:
    """The K-Planes hybrid encoding: `features` a plane a scale, spatial
    resolution base_resolution x m a side for each m of `multipliers`, time
    resolution `time_resolution` at every scale."""

    base_resolution: int = 64
    multipliers: tuple = (1, 2, 4, 8)
    time_resolution: int = 25
    features: int = 32

    def __post_init__(self):
        if not 1 <= len(self.multipliers) <= MAX_SCALES:
            raise ValueError(f"K-Planes takes 1 to {MAX_SCALES} scales, got {len(self.multipliers)}")
        if min(self.resolutions()) < 2 or self.time_resolution < 2 or self.features < 1:
            raise ValueError("K-Planes planes need 2 or more points a side and 1 or more features")

    def resolutions(self) -> list[int]:
        return [int(self.base_resolution * m) for m in self.multipliers]

    @property
    def out_dim(self) -> int:
        return len(self.multipliers) * self.features

    def plane_shape(self, scale: int, plane: str) -> tuple[int, int, int]:
        """[F, res_b, res_a] of `plane` at `scale`."""
        r = self.resolutions()[scale]
        a, b = _AXES[plane]
        return (self.features, self.time_resolution if b == "t" else r, self.time_resolution if a == "t" else r)

    def num_params(self) -> int:
        return sum(int(np.prod(self.plane_shape(l, p))) for l in range(len(self.multipliers)) for p in PLANES)


def init_params(cfg: KPlanesConfig, seed: int = 0, device="cuda") -> dict:
    """The planes from `seed` (numpy MT19937): planes containing t are 1,
    the others U(INIT_LOW, INIT_HIGH), as the published code's init."""
    rng = np.random.Generator(np.random.MT19937(seed))
    out = {}
    for l in range(len(cfg.multipliers)):
        scale = {}
        for p in PLANES:
            shape = cfg.plane_shape(l, p)
            if "t" in p:
                v = np.ones(shape, dtype=np.float32)
            else:
                v = rng.uniform(INIT_LOW, INIT_HIGH, shape).astype(np.float32)
            scale[p] = torch.tensor(v, device=device)
        out[f"s{l}"] = scale
    return out


def schedule_meta(cfg: KPlanesConfig) -> dict:
    """Checkpoint fingerprint (keys of this family alone)."""
    return {
        "kplanes_base_resolution": cfg.base_resolution,
        "kplanes_multipliers": [int(m) for m in cfg.multipliers],
        "kplanes_time_resolution": cfg.time_resolution,
        "kplanes_features": cfg.features,
    }


def planes_list(cfg: KPlanesConfig, tables: dict) -> list:
    """The planes scale-major, PLANES order within a scale."""
    return [tables[f"s{l}"][p] for l in range(len(cfg.multipliers)) for p in PLANES]


# ---------------------------------------------------------------------------
# Sampling positions and the plain encoder
# ---------------------------------------------------------------------------


def _position(c: torch.Tensor, r: int):
    """(lower index, weight of the upper) of float32 coordinates c in
    [-1, 1] on an axis of r points: ((c + 1) / 2) (r - 1), clamped to
    [0, r - 1] (padding "border"); the lower index at most r - 2."""
    pos = torch.clamp(((c + 1.0) * 0.5) * float(r - 1), 0.0, float(r - 1))
    i0 = torch.clamp(torch.floor(pos), max=float(r - 2))
    return i0.long(), pos - i0


def _node_coords(n: int, device) -> torch.Tensor:
    """c = 2u - 1 of the n grid nodes of an axis, u = i / (n - 1), each an
    IEEE float32 operation (numpy's, whatever the device: the card's torch
    divides by a scalar through its reciprocal)."""
    if n <= 1:
        return torch.full((max(n, 1),), -1.0, dtype=torch.float32, device=device)
    u = np.arange(n, dtype=np.float32) / np.float32(n - 1)
    return torch.tensor(np.float32(2.0) * u - np.float32(1.0), device=device)


def _lerp(p: torch.Tensor, dim: int, i0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    shape = [1] * p.dim()
    shape[dim] = -1
    w = w.reshape(shape)
    return (1.0 - w) * p.index_select(dim, i0) + w * p.index_select(dim, i0 + 1)


def _sample_plane(p: torch.Tensor, ca: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """The plane p [F, Rb, Ra] at every pair of the coordinates ca [Na] and
    cb [Nb] -> [F, Nb, Na]: the lerp along a, then along b (positions in
    the plane's dtype: float64 planes take float64 positions of the float32
    coordinates, as grid_sample does)."""
    ia, wa = _position(ca.to(p.dtype), p.shape[2])
    ib, wb = _position(cb.to(p.dtype), p.shape[1])
    return _lerp(_lerp(p, 2, ia, wa), 1, ib, wb)


def node_tables(cfg: KPlanesConfig, tables: dict, g, ts: torch.Tensor) -> dict:
    """The planes sampled at the grid's nodes and the slice times ts [S]:
    XY [LF, ny, nx], XZ [LF, nz, nx], YZ [LF, nz, ny]; XT [S, LF, nx],
    YT [S, LF, ny], ZT [S, LF, nz]; the scales concatenated (plain ops)."""
    dev = ts.device
    c = {"x": _node_coords(g.nx, dev), "y": _node_coords(g.ny, dev), "z": _node_coords(g.nz, dev),
         "t": 2.0 * ts.to(torch.float32) - 1.0}
    out = {k: [] for k in ("XY", "XZ", "YZ", "XT", "YT", "ZT")}
    for l in range(len(cfg.multipliers)):
        s = tables[f"s{l}"]
        for p in PLANES:
            a, b = _AXES[p]
            v = _sample_plane(s[p], c[a], c[b])  # [F, Nb, Na]
            out[p.upper()].append(torch.movedim(v, 1, 0) if b == "t" else v)
    return {k: torch.cat(v, dim=1 if k.endswith("T") else 0) for k, v in out.items()}


def encode_from_nodes(nt: dict) -> torch.Tensor:
    """[S, nz, LF, ny, nx]: ((((XY XZ) XT) YZ) YT) ZT at every cell."""
    xy = nt["XY"][None, None]  # [1, 1, LF, ny, nx]
    xz = torch.movedim(nt["XZ"], 1, 0)[None, :, :, None, :]  # [1, nz, LF, 1, nx]
    yz = torch.movedim(nt["YZ"], 1, 0)[None, :, :, :, None]  # [1, nz, LF, ny, 1]
    xt = nt["XT"][:, None, :, None, :]  # [S, 1, LF, 1, nx]
    yt = nt["YT"][:, None, :, :, None]  # [S, 1, LF, ny, 1]
    zt = torch.movedim(nt["ZT"], 2, 1)[:, :, :, None, None]  # [S, nz, LF, 1, 1]
    return ((((xy * xz) * xt) * yz) * yt) * zt


def encode_grid_zcf_slices_plain(cfg: KPlanesConfig, tables: dict, g, ts: torch.Tensor) -> torch.Tensor:
    """encode_grid_zcf_slices by plain ops on any device (autograd pulls it
    back)."""
    return encode_from_nodes(node_tables(cfg, tables, g, ts))


def encode_points(cfg: KPlanesConfig, tables: dict, coords: torch.Tensor, t) -> torch.Tensor:
    """coords [..., 3] in [0, 1] (x, y, z) at time t -> [..., out_dim], the
    same samples and products at arbitrary points."""
    shape = coords.shape[:-1]
    pts = coords.reshape(-1, 3).to(torch.float32)
    n = pts.shape[0]
    tt = torch.as_tensor(t, dtype=torch.float32, device=pts.device).expand(n)
    c = {"x": 2.0 * pts[:, 0] - 1.0, "y": 2.0 * pts[:, 1] - 1.0, "z": 2.0 * pts[:, 2] - 1.0, "t": 2.0 * tt - 1.0}
    outs = []
    for l in range(len(cfg.multipliers)):
        s = tables[f"s{l}"]
        feat = None
        for p in PLANES:
            a, b = _AXES[p]
            plane = s[p]
            ia, wa = _position(c[a].to(plane.dtype), plane.shape[2])
            ib, wb = _position(c[b].to(plane.dtype), plane.shape[1])
            wa, wb = wa[:, None], wb[:, None]
            r0 = (1.0 - wa) * plane[:, ib, ia].T + wa * plane[:, ib, ia + 1].T
            r1 = (1.0 - wa) * plane[:, ib + 1, ia].T + wa * plane[:, ib + 1, ia + 1].T
            v = (1.0 - wb) * r0 + wb * r1  # [N, F]
            feat = v if feat is None else feat * v
        outs.append(feat)
    return torch.cat(outs, dim=-1).reshape(*shape, cfg.out_dim)


# ---------------------------------------------------------------------------
# The kernels (csrc/kplanes_encode.cu)
# ---------------------------------------------------------------------------


def max_time_window(cfg: KPlanesConfig, dt: float) -> bool:
    """Whether the three slices t - dt .. t + dt lie within three time
    points of the planes (2 dt (T - 1) <= 0.9): the pull-back's window."""
    return 2.0 * float(dt) * (cfg.time_resolution - 1) <= 0.9


def _ptrs(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers."""
    return (ctypes.c_longlong * len(tensors))(*(x.data_ptr() for x in tensors))


def _res_array(cfg: KPlanesConfig) -> ctypes.Array:
    return (ctypes.c_int * len(cfg.multipliers))(*cfg.resolutions())


def node_floats(cfg: KPlanesConfig, g, s: int) -> int:
    lf = cfg.out_dim
    return lf * (g.ny * g.nx + g.nz * g.nx + g.nz * g.ny) + s * lf * (g.nx + g.ny + g.nz)


def _launch_encode(cfg: KPlanesConfig, g, ts: torch.Tensor, planes) -> tuple[torch.Tensor, torch.Tensor]:
    from phys_autodiff_tpu_torch.kernels import _build  # the kernels package imports the models

    dev = ts.device
    s = ts.shape[0]
    nodes = torch.empty(node_floats(cfg, g, s), dtype=torch.float32, device=dev)
    enc = torch.empty((s, g.nz, cfg.out_dim, g.ny, g.nx), dtype=torch.float32, device=dev)
    ptrs, res = _ptrs(planes), _res_array(cfg)
    with torch.cuda.device(dev):
        err = _build.lib().pat_kplanes_encode(
            ctypes.addressof(ptrs), ctypes.addressof(res), len(cfg.multipliers), cfg.time_resolution,
            cfg.features, ts.data_ptr(), s, nodes.data_ptr(), enc.data_ptr(), g.nx, g.ny, g.nz,
            _build.stream_ptr(dev))
    _build.check(err, "K-Planes encode kernel", "kplanes_encode", (enc,))
    _build.LAUNCHES["kplanes_encode"] += 1
    return enc, nodes


#: Rows of y a block of the pull-back's main pass takes (csrc/kplanes_encode.cu YC).
PULL_YC = 4
#: Cells of x a block of the main pass takes (its threads).
PULL_XC = 256


def pull_scratch_floats(cfg: KPlanesConfig, g) -> int:
    """The pull-back's scratch: the main pass's partials over y chunks
    (XZ, XT, ZT) and x chunks (YZ, YT, ZT), and their sums."""
    lf = cfg.out_dim
    nyc, nxc = -(-g.ny // PULL_YC), -(-g.nx // PULL_XC)
    return (lf * g.ny * g.nx + nyc * lf * g.nz * g.nx + nxc * lf * g.nz * g.ny + nyc * lf * 3 * g.nx
            + nxc * lf * 3 * g.ny + nyc * nxc * lf * 3 * g.nz + lf * (g.nz * g.nx + g.nz * g.ny)
            + lf * 3 * (g.nx + g.ny + g.nz))


def _launch_pullback(cfg: KPlanesConfig, g, ts: torch.Tensor, nodes: torch.Tensor, shapes, d_enc: torch.Tensor):
    """Every plane's gradient (views of one flat buffer, in planes_list's
    order) from d_enc [S, nz, LF, ny, nx] and the forward's node tables."""
    from phys_autodiff_tpu_torch.kernels import _build

    dev = ts.device
    s = ts.shape[0]
    _build.check_shape(d_enc, (s, g.nz, cfg.out_dim, g.ny, g.nx), "d_enc")
    d_enc = d_enc.contiguous()
    scratch = torch.empty(pull_scratch_floats(cfg, g), dtype=torch.float32, device=dev)
    grad = torch.empty(cfg.num_params(), dtype=torch.float32, device=dev)
    res = _res_array(cfg)
    with torch.cuda.device(dev):
        err = _build.lib().pat_kplanes_pullback(
            ctypes.addressof(res), len(cfg.multipliers), cfg.time_resolution, cfg.features, ts.data_ptr(), s,
            nodes.data_ptr(), d_enc.data_ptr(), scratch.data_ptr(), grad.data_ptr(), g.nx, g.ny, g.nz,
            _build.stream_ptr(dev))
    _build.check(err, "K-Planes encode pull-back kernel", "kplanes_encode pullback", (grad,))
    _build.LAUNCHES["kplanes_encode pullback"] += 1
    grads, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        grads.append(grad[off:off + n].view(shape))
        off += n
    return grads


class _EncodeKernel(torch.autograd.Function):
    """encode_grid_zcf_slices by csrc/kplanes_encode.cu, one entry; its
    pull-back one entry, a gradient for each plane."""

    @staticmethod
    def forward(ctx, cfg, g, ts, *planes):
        enc, nodes = _launch_encode(cfg, g, ts, planes)
        ctx.cfg, ctx.g, ctx.shapes = cfg, g, [tuple(p.shape) for p in planes]
        ctx.save_for_backward(ts, nodes)
        return enc

    @staticmethod
    def backward(ctx, d_enc):
        ts, nodes = ctx.saved_tensors
        return (None, None, None, *_launch_pullback(ctx.cfg, ctx.g, ts, nodes, ctx.shapes, d_enc))


def _on_card(tables: dict) -> bool:
    dev = tables["s0"]["xy"].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K-Planes encoder for device {dev}")
    return dev.type == "cuda"


def encode_grid_zcf_slices(cfg: KPlanesConfig, tables: dict, g, ts) -> torch.Tensor:
    """The encodings of the grid at the times ts [S] -> [S, nz, LF, ny, nx]
    (z-major channel-first, the per-slice K5's input layout). CPU tables
    take the plain ops, CUDA tables the kernel pair, whose values are the
    plain ops' bit for bit (the kernels round each product as the plain ops
    do) and whose pull-back sums in a fixed order."""
    with annotate("pat.encode"):
        ts = torch.as_tensor(ts, dtype=torch.float32, device=tables["s0"]["xy"].device).reshape(-1)
        if not _on_card(tables):
            return encode_grid_zcf_slices_plain(cfg, tables, g, ts)
        planes = planes_list(cfg, tables)
        for l, p in enumerate(PLANES * len(cfg.multipliers)):
            x = planes[l]
            if x.dtype != torch.float32 or not x.is_contiguous() or x.device != ts.device:
                raise ValueError("the K-Planes encode kernel takes contiguous float32 planes on one device")
            if tuple(x.shape) != cfg.plane_shape(l // len(PLANES), p):
                raise ValueError(f"plane {p} of scale {l // len(PLANES)}: expected shape "
                                 f"{cfg.plane_shape(l // len(PLANES), p)}, got {tuple(x.shape)}")
        if ts.shape[0] > 1 and not max_time_window(cfg, g.dt):
            raise ValueError(f"the K-Planes pull-back takes 2 dt (T - 1) <= 0.9 (dt {g.dt}, T {cfg.time_resolution})")
        if ts.shape[0] > 3:
            raise ValueError(f"the K-Planes encode kernel takes 1 to 3 slices, got {ts.shape[0]}")
        return _EncodeKernel.apply(cfg, g, ts.contiguous(), *planes)

