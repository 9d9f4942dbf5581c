"""The K-Planes encoded field (models/kplanes.py, the per-slice K5 of
kernels/mega_ngp.py) on the CPU, against the plain reference of
phys_autodiff_tpu_torch/ref/kplanes.py (grid_sample on the 4-D
coordinates, as the published code samples its planes).

A small configuration: a 12 x 10 x 8 grid, scales 4 and 8, time resolution
5, 4 features a plane (LF 8), a head of 16. The planes are drawn U(0.5,
1.5), the time planes included, so that the encoding moves with t; the
head and its biases are random. Tolerances, each with its reason:
  * encoder, float64: 1e-12 relative. grid_sample weighs a cell's four
    corners by products of the axis weights, the port lerps along one axis
    then the other: the same function, rounded apart.
  * encoder, float32: 2e-6 relative (a few float32 ulps of the six-factor
    product, the same reason).
  * pull-back, float64 1e-10; float32 2e-5 relative per plane (autograd
    sums the cells' cotangents in another order).
  * the whole loss and gradient, float32 against the float64 reference:
    the loss 1e-5 relative, every leaf 2e-4 of its largest entry (the t -+
    dt legs are 1/(2 dt) = 25 times the t slice's and nearly cancel, which
    magnifies the float32 rounding of the fields that much; the same bound
    as the hash field's K5 tests).
"""

import dataclasses

import numpy as np
import pytest
import torch

from phys_autodiff_tpu_torch import GridSpec, PhysWeights
from phys_autodiff_tpu_torch import cli
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega_ngp as k5
from phys_autodiff_tpu_torch.models import encoders, kplanes, modelio, ngp, sample
from phys_autodiff_tpu_torch.models.kplanes import KPlanesConfig
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.ref import kplanes as ref
from phys_autodiff_tpu_torch.train import loop
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

ENC = KPlanesConfig(base_resolution=4, multipliers=(1, 2), time_resolution=5, features=4)
CFG = ngp.NGPFieldConfig(encoding=ENC, hidden=16)
G = GridSpec(nx=12, ny=10, nz=8, hx=0.3, hy=0.3, hz=0.3, dt=2e-2)
W = PhysWeights(w_sigma=1.3, w_u=0.7)
#: t: inside one time interval, across a time point (1.5 / 4 = 0.375 lies
#: between t - dt and t + dt), and at the border (t - dt < 0 clamps)
TIMES = [0.31, 0.37, 0.01]


def _params(seed=5, dtype=torch.float32):
    rng = np.random.Generator(np.random.MT19937(seed))
    p = ngp.init_ngp_params(CFG, seed=seed, device="cpu")
    p = tree.map_tree(lambda x: x, p)
    for l in range(len(ENC.multipliers)):
        for name in kplanes.PLANES:
            shape = ENC.plane_shape(l, name)
            p["tables"][f"s{l}"][name] = torch.tensor(rng.uniform(0.5, 1.5, shape).astype(np.float32))
    p["b1"] = torch.tensor(rng.uniform(-0.3, 0.3, (CFG.hidden,)).astype(np.float32))
    p["b2"] = torch.tensor(rng.uniform(-0.3, 0.3, (4,)).astype(np.float32))
    return tree.map_tree(lambda x: x.to(dtype), p)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max())


def _ts(t, dtype=torch.float32):
    t32, dt32 = np.float32(t), np.float32(G.dt)
    return torch.tensor([t32 - dt32, t32, t32 + dt32], dtype=torch.float32).to(dtype)


def _ref_encodings(tables, ts):
    """[S, nz, LF, ny, nx] of the reference, a slice a time."""
    dtype = tables["s0"]["xy"].dtype
    outs = []
    for t in ts:
        e = ref.interpolate_features(tables, ref.grid_points(G, t, dtype))  # [N, LF]
        outs.append(torch.movedim(e.reshape(G.nz, G.ny, G.nx, -1), -1, 1))
    return torch.stack(outs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("t", TIMES)
def test_plain_encoder_and_pull_back_match_the_reference(dtype, t):
    tables = tree.map_tree(lambda x: x.detach().requires_grad_(), _params(dtype=dtype)["tables"])
    ts = _ts(t)
    port = kplanes.encode_grid_zcf_slices(ENC, tables, G, ts)
    want = _ref_encodings(tables, ts)
    assert port.shape == (3, G.nz, ENC.out_dim, G.ny, G.nx) and port.dtype == dtype
    assert _rel(port, want) <= (1e-12 if dtype == torch.float64 else 2e-6)
    cot = torch.tensor(np.random.default_rng(3).standard_normal(port.shape), dtype=dtype)
    leaves = tree.leaves(tables)
    gp = torch.autograd.grad(port, leaves, cot)
    gr = torch.autograd.grad(want, leaves, cot)
    for a, b in zip(gp, gr):
        assert _rel(a, b) <= (1e-10 if dtype == torch.float64 else 2e-5)


def test_points_at_the_nodes_are_the_grid_encoding():
    p = _params()
    ts = _ts(0.37)
    grid = kplanes.encode_grid_zcf_slices(ENC, p["tables"], G, ts)[1]  # [nz, LF, ny, nx]
    # the nodes' unit coordinates u, exactly (c = 2u - 1 in float32 round trips)
    u = [np.arange(n, dtype=np.float32) / np.float32(n - 1) for n in (G.nz, G.ny, G.nx)]
    zz, yy, xx = np.meshgrid(*u, indexing="ij")
    pts = torch.tensor(np.stack([xx, yy, zz], -1).reshape(-1, 3))
    got = kplanes.encode_points(ENC, p["tables"], pts, ts[1])
    np.testing.assert_array_equal(got.reshape(G.nz, G.ny, G.nx, -1).numpy(), torch.movedim(grid, 1, -1).numpy())


def _reference_loss_and_grad(params, t):
    """float64 autograd through the reference's fields and the staged
    transport loss."""
    p = tree.map_tree(lambda x: x.detach().double().requires_grad_(), params)
    sigma, u = ref.slice_fields(p, G, t, G.dt)
    fields = FieldSnapshots(sigma[0], sigma[1], sigma[2], u[0], u[1], u[2])
    loss = ops_loss.total_loss(G, W, fields)
    grads = torch.autograd.grad(loss, tree.leaves(p))
    return loss.detach(), grads


def _check_against_reference(loss, grads, params, t):
    want_loss, want = _reference_loss_and_grad(params, t)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for a, b in zip(tree.leaves(grads), want):
        assert a.shape == b.shape and _rel(a, b) <= 2e-4


@pytest.mark.parametrize("t", TIMES)
def test_cpu_mega_path_matches_the_reference(t):
    params = _params()
    loss, (grads, grad_t) = k5.ngp_loss_and_grad(G, W, CFG, params, t)
    assert grad_t is None  # t enters through the encoder
    _check_against_reference(loss, grads, params, t)


@pytest.mark.parametrize("t", TIMES)
def test_xla_arm_matches_the_reference(t):
    params = _params()
    loss, (grads, grad_t) = k5.ngp_loss_and_grad_plain(G, W, CFG, params, t)
    _check_against_reference(loss, grads, params, t)
    assert torch.isfinite(grad_t)


def test_train_step_arms_agree():
    params = _params()
    cfg = loop.TrainConfig(learning_rate=1e-3, t_sampling="uniform", seed=9)
    mega, s_mega = loop.make_ngp_train_step(G, W, CFG, cfg, params, backward="mega")
    xla, s_xla = loop.make_ngp_train_step(G, W, CFG, cfg, params, backward="xla")
    for _ in range(2):
        s_mega, l_mega = mega(s_mega)
        s_xla, l_xla = xla(s_xla)
        assert abs(float(l_mega) - float(l_xla)) <= 1e-5 * abs(float(l_xla))
    for a, b in zip(tree.leaves(s_mega.params), tree.leaves(s_xla.params)):
        assert float((a - b).abs().max()) <= 1e-6


def test_plain_head_is_held_to_its_referee():
    params = _params()
    ts = _ts(0.37)
    encs = kplanes.encode_grid_zcf_slices(ENC, params["tables"], G, ts)
    args = (encs, params["W1"], params["b1"], params["W2"], params["b2"])
    lp, gp = k5.slices_head_loss_and_grad_plain(G, W, *args)
    lr, gr = k5.slices_head_loss_and_grad_ref(G, W, *args)
    assert _rel(lp, lr) <= 1e-5
    for a, b in zip(gp, gr):
        assert _rel(a, b) <= 2e-4


def test_init_and_the_published_parameter_count():
    full = ngp.NGPFieldConfig(encoding=KPlanesConfig(), hidden=64)
    assert full.head_in == 128 and full.encoding.out_dim == 128
    spatial = 3 * sum(r * r for r in (64, 128, 256, 512)) * 32
    timed = 3 * sum((64, 128, 256, 512)) * 25 * 32
    assert (spatial, timed) == (33_423_360, 2_304_000)
    head = 128 * 64 + 64 + 64 * 4 + 4
    assert KPlanesConfig().num_params() + head == 35_735_876
    p = ngp.init_ngp_params(CFG, seed=3, device="cpu")
    assert sum(x.numel() for x in tree.leaves(p)) == ENC.num_params() + 8 * 16 + 16 + 16 * 4 + 4
    for l in range(2):
        for name, x in p["tables"][f"s{l}"].items():
            assert x.shape == ENC.plane_shape(l, name)
            if "t" in name:
                assert bool((x == 1.0).all())
            else:
                assert 0.1 <= float(x.min()) and float(x.max()) < 0.5
    lim = np.sqrt(6.0 / (8 + 16))
    assert p["W1"].shape == (8, 16) and float(p["W1"].abs().max()) <= lim
    assert not p["b1"].any() and not p["b2"].any()
    again = ngp.init_ngp_params(CFG, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(p), tree.leaves(again)))


@pytest.mark.parametrize("precision", ["bf16", "f32_fastbwd"])
def test_tiers_other_than_f32_raise_naming_the_family(precision):
    params = _params()
    with pytest.raises(ValueError, match="kplanes"):
        k5.ngp_loss_and_grad(G, W, CFG, params, 0.3, precision=precision)
    for backward in ("mega", "auto"):
        with pytest.raises(ValueError, match="kplanes"):
            loop.resolve_ngp_backward(backward, G, CFG, precision, on_card=True)


def test_fit_kernel_and_sharded_step_raise_naming_the_family():
    params = _params()
    target = torch.zeros(4, G.nz, G.ny, G.nx)
    with pytest.raises(ValueError, match="kplanes"):
        kfit.ngp_fit_loss_and_grad(G, CFG, params, target, 0.25)
    with pytest.raises(ValueError, match="kplanes"):
        k5.ngp_loss_and_grad_sharded(G, W, CFG, mesh=None)
    with pytest.raises(ValueError, match="kplanes"):
        encoders.encode_grid_zcf(ENC, params["tables"], G)


def test_card_gates_take_lf_128_and_h_64():
    full = ngp.NGPFieldConfig(encoding=KPlanesConfig(), hidden=64)
    assert loop.resolve_ngp_backward("mega", G, full, on_card=True) == "mega"
    wide = dataclasses.replace(full, hidden=65)
    assert loop.resolve_ngp_backward("auto", G, wide, on_card=True) == "xla"
    with pytest.raises(ValueError, match="H <= 64"):
        loop.resolve_ngp_backward("mega", G, wide, on_card=True)


def test_grid_infer_matches_the_reference_field():
    params = _params()
    got = sample.grid_infer_any(G, CFG, params, 0.37)
    want = ref.field(tree.map_tree(lambda x: x.double(), params), G, 0.37)
    assert got.shape == (G.nz, G.ny, G.nx, 4) and _rel(got, want) <= 1e-5


def _run(capsys, argv):
    import json

    rc = cli.main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_trains_and_serves_the_kplanes_family(capsys, tmp_path):
    ckpt = str(tmp_path / "kp.npz")
    model = ["--family", "kplanes", "--hidden", "8", "--kp-base", "4", "--kp-multipliers", "1,2", "--kp-time-res",
             "5", "--kp-features", "2"]
    rc, out = _run(capsys, ["train", "--grid", "8x6x6", "--steps", "3", *model, "--out", ckpt, "--device", "cpu"])
    assert rc == 0 and np.isfinite(out["loss_last"])
    g, mcfg, params = modelio.load_model(ckpt, device="cpu")
    assert mcfg.encoding == KPlanesConfig(base_resolution=4, multipliers=(1, 2), time_resolution=5, features=2)
    rc, out = _run(capsys, ["serve", "--ckpt", ckpt, "--t", "0.4", "--out", str(tmp_path / "s.npz"), "--device",
                            "cpu"])
    assert rc == 0 and out["grid"] == [8, 6, 6]
    served = np.load(out["out"])
    want = sample.grid_infer_any(g, mcfg, params, 0.4).detach().numpy()
    np.testing.assert_array_equal(served["sigma"], want[..., 0])
