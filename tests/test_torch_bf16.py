"""The bf16 tier of the MLP kernels K2 (bf16, bf16x3), K3, K4 and K6, and the
routing of "f32_high" (and of "bf16x3" outside K2), vs the JAX package's
same-named tiers (Pallas in interpret mode).

On the CPU the port runs the kernels' plain versions: layer 1 in float32,
layer 2 with every operand rounded to bf16 and float32 sums
(kernels/mlp.py _Layer2Bf16, whose backward rounds gy, a1 and W2 as the
TPU's dW2 and da1 contractions do). Tolerances:
  * K2 fields: MLP_INFER_REL (1e-6 relative L2) against JAX; against the
    port's own f32 fields within 5e-3 (tests/test_mlp_fused.py:98-105) and
    further than 1e-4, so the tier really rounds.
  * K3 and K4 losses: 1e-5 relative against JAX; K3 within 5e-2 of the
    staged f32 loss (tests/test_mega.py:155-163).
  * K4 gradients: 1e-2 relative L2 on the concatenation. JAX's interpret
    mode computes K4's da1 = W2 . gy in float32 (DEFAULT precision on the
    CPU, ROADMAP.md R2), where the TPU and the port round W2 and gy to bf16
    first; the measured difference is 8.6e-4 at H = 32 and 9.8e-4 at H = 40.
  * K6: JAX rounds K6's da1 operands on the CPU too (pallas/fit.py:183-190),
    so the loss is held at 1e-6 and every gradient leaf at 2e-5 relative
    (atol 1e-7), the f32 K6 tolerances (tests/test_torch_fit_kernel.py:7-9).
  * three training and fit steps: losses 1e-3 relative (BF16_REL).
  * f32_high, and bf16x3 for K3, K4 and K6: bit for bit the port's own f32
    result, and against JAX's same tier at the f32 tests' tolerances.
The grids are 128x8x6 (lane-aligned planes, so the JAX kernels run) and
16x8x6 for the fit (ny * nx = 128).
"""

import dataclasses
import enum

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu import ops as jops
from phys_autodiff_tpu.models import generate_fields as jgenerate
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.pallas import fit as jfit
from phys_autodiff_tpu.pallas import mega as jmega
from phys_autodiff_tpu.pallas import mlp as jpmlp
from phys_autodiff_tpu.pallas.mega_bwd import mega_loss_and_grad as jmega_lg
from phys_autodiff_tpu.train import fit_field as jff
from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels import fit as kfit
from phys_autodiff_tpu_torch.kernels import mega as kmega
from phys_autodiff_tpu_torch.kernels import mega_bwd as kbwd
from phys_autodiff_tpu_torch.kernels import mlp as kmlp
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.train import TrainConfig, make_train_step, state_from_params
from phys_autodiff_tpu_torch.train import fit_field as ff

torch.set_num_threads(1)

MLP_INFER_REL = 1e-6
BF16_REL = 1e-3
W = PhysWeights(w_sigma=1.3, w_u=0.7)
G = GridSpec(nx=128, ny=8, nz=6, hx=0.3, hy=0.35, hz=0.4, dt=1e-2)
G_FIT = GridSpec(nx=16, ny=8, nz=6, hx=0.2, hy=0.2, hz=0.2, dt=1e-3)
T = 0.3


def _jax(x):
    """The JAX package's config with the field values of the port's config x."""
    if isinstance(x, enum.Enum):
        return getattr(jconfig, type(x).__name__)(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = jloop if hasattr(jloop, type(x).__name__) and type(x).__name__ == "TrainConfig" else jconfig
    return getattr(mod, type(x).__name__)(**{f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _setup(h=32, seed=3):
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    jp = jmlp.init_params(_jax(cfg.dims), seed=seed)
    return cfg, jp, tmlp.params_from_jax({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _fields_np(fs):
    return np.concatenate([np.asarray(x).ravel() for x in fs])


def _target(g, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=g.shape).astype(np.float32), (0.5 * rng.normal(size=(3,) + g.shape)).astype(np.float32)


def _cat(gp):
    return np.concatenate([np.asarray(gp[k], np.float64).ravel() for k in sorted(gp)])


# ---------------------------------------------------------------- K2


@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
@pytest.mark.parametrize("h", [32, 40])
def test_k2_tier_matches_jax(tier, h):
    cfg, jp, tp = _setup(h)
    ref = _fields_np(jpmlp.generate_fields_fused(_jax(G), _jax(cfg), jp, T, tier, True))
    got = _fields_np(kmlp.generate_fields_fused(G, cfg, tp, T, tier))
    assert _rel(got, ref) <= MLP_INFER_REL
    packed = kmlp.generate_fields_fused_packed(G, cfg, tp, T, tier)
    ref_packed = np.asarray(jpmlp.generate_fields_fused_packed(_jax(G), _jax(cfg), jp, T, tier, True))
    assert _rel(packed.numpy(), ref_packed) <= MLP_INFER_REL
    y1 = kmlp.grid_infer_fused(G, cfg, tp, T, tier).numpy()
    assert _rel(y1, np.asarray(jpmlp.grid_infer_fused(_jax(G), _jax(cfg), jp, T, tier, True))) <= MLP_INFER_REL


@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
def test_k2_tier_really_rounds(tier):
    """bf16 sits between 1e-4 and 5e-3 of the f32 fields; bf16x3 (three
    split products) much closer to f32 than bf16 but not equal."""
    cfg, _, tp = _setup(32)
    f32 = _fields_np(kmlp.generate_fields_fused(G, cfg, tp, T))
    got = _fields_np(kmlp.generate_fields_fused(G, cfg, tp, T, tier))
    d = _rel(got, f32)
    if tier == "bf16":
        assert 1e-4 < d <= 5e-3
    else:
        assert 0.0 < d <= 1e-5


def test_k2_bf16_is_differentiable_with_the_staged_backward():
    """K2's VJP is autograd through the staged float32 fields in every tier
    (pallas/mlp.py:450-456): the bf16 forward leaves the gradient alone."""
    cfg, _, tp = _setup(32)

    def grads(precision):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        fs = kmlp.generate_fields_fused(G, cfg, p, T, precision)
        loss = sum(torch.sum(x * x) for x in fs)
        return torch.autograd.grad(loss, [p[k] for k in sorted(p)])

    for a, b in zip(grads("bf16"), grads("f32")):
        assert _rel(a.numpy(), b.numpy()) < 2e-2


# ---------------------------------------------------------------- K3


@pytest.mark.parametrize("h", [32, 40])
def test_k3_bf16_loss_matches_jax_and_the_k2_k1_pipeline(h):
    cfg, jp, tp = _setup(h)
    ls, lu = kmega.mega_loss_pipeline(G, W, cfg, tp, T, "bf16")
    js, ju = jmega.mega_loss_pipeline(_jax(G), _jax(W), _jax(cfg), jp, T, "bf16", True)
    assert abs(float(ls) - float(js)) <= 1e-5 * abs(float(js))
    assert abs(float(lu) - float(ju)) <= 1e-5 * abs(float(ju))
    staged = ops_loss.loss_forward(G, W, tfields.generate_fields(G, cfg, tp, T, G.dt))
    for a, b in zip((ls, lu), staged):
        assert abs(float(a) - float(b)) <= 5e-2 * abs(float(b))
    fs, fu = kmlp.fused_loss_pipeline(G, W, cfg, tp, T, "bf16")
    assert abs(float(ls) - float(fs)) <= 1e-5 * abs(float(fs))
    assert abs(float(lu) - float(fu)) <= 1e-5 * abs(float(fu))


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("h", [32, 40])
def test_k4_bf16_loss_and_grad_match_jax(h):
    """Loss 1e-5; the concatenated gradient 1e-2 (JAX's CPU da1 is float32,
    see the module docstring; measured 8.6e-4 at H = 32, 9.8e-4 at H = 40)."""
    cfg, jp, tp = _setup(h)
    loss, (gp, gt) = kbwd.mega_loss_and_grad(G, W, cfg, tp, T, "bf16")
    jl, (jgp, jgt) = jmega_lg(_jax(G), _jax(W), _jax(cfg), jp, jnp.float32(T), "bf16", True)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _rel(_cat({k: v.numpy() for k, v in gp.items()}), _cat(jgp)) <= 1e-2
    # the bf16 backward is not the f32 one
    _, (gp32, _) = kbwd.mega_loss_and_grad(G, W, cfg, tp, T)
    assert _rel(_cat({k: v.numpy() for k, v in gp.items()}), _cat({k: v.numpy() for k, v in gp32.items()})) > 1e-4


def test_bf16_layer2_backward_rounds_every_operand():
    """dW2T = bf16(gy)^T bf16(a1) and da1 = bf16(gy) bf16(W2T) in float32,
    not the straight-through gradient of a cast."""
    rng = np.random.default_rng(0)
    a1 = torch.tensor(np.abs(rng.normal(size=(64, 24))).astype(np.float32), requires_grad=True)
    w2t = torch.tensor(rng.normal(size=(4, 24)).astype(np.float32), requires_grad=True)
    gy = torch.tensor(rng.normal(size=(64, 4)).astype(np.float32))
    y = kmlp.layer2(a1, w2t, "bf16", 1)
    da1, dw = torch.autograd.grad(y, (a1, w2t), gy)

    def b(x):
        return x.detach().to(torch.bfloat16).double()

    np.testing.assert_allclose(y.detach().numpy(), (b(a1) @ b(w2t).T).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), (b(gy).T @ b(a1)).numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(da1.numpy(), (b(gy) @ b(w2t)).numpy(), rtol=1e-6, atol=1e-6)
    assert not np.allclose(dw.numpy(), (gy.double().T @ b(a1)).numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- K6


@pytest.mark.parametrize("h", [32, 40])
def test_k6_bf16_loss_and_every_leaf_match_jax(h):
    cfg, jp, tp = _setup(h)
    sigma, u = _target(G_FIT)
    wf = PhysWeights(w_sigma=1.3, w_u=0.6)
    loss, (gp, gt) = kfit.fit_loss_and_grad(G_FIT, cfg, tp, kfit.pack_target(G_FIT, sigma, u), T, wf, "bf16")
    jtarget = jfit.pack_target(_jax(G_FIT), jnp.asarray(sigma), jnp.asarray(u))
    jl, (jgp, jgt) = jfit.fit_loss_and_grad(_jax(G_FIT), _jax(cfg), jp, jtarget, T, _jax(wf), "bf16", True)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), np.asarray(jgp[k]), rtol=2e-5, atol=1e-7)
    assert abs(float(gt) - float(jgt)) <= 1e-4 * abs(float(jgt))
    _, (gp32, _) = kfit.fit_loss_and_grad(G_FIT, cfg, tp, kfit.pack_target(G_FIT, sigma, u), T, wf)
    assert _rel(_cat({k: v.numpy() for k, v in gp.items()}), _cat({k: v.numpy() for k, v in gp32.items()})) > 1e-4


# ---------------------------------------------------------------- the slice


def test_three_bf16_training_steps_match_jax():
    """make_train_step(TrainConfig(use_fused=True, precision="bf16")): K4's
    bf16 tier once a step, against JAX's same config."""
    kw = dict(seed=5, learning_rate=3e-3, use_fused=True, precision="bf16")
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    jcfg = jloop.TrainConfig(**kw)
    jstate = jloop.init_state(jcfg, _jax(cfg))
    jstep = jloop.make_train_step(_jax(G), _jax(W), _jax(cfg), jcfg)
    tcfg = TrainConfig(**kw)
    state = state_from_params(tcfg, tmlp.params_from_jax({k: np.asarray(v) for k, v in jstate.params.items()},
                                                         device="cpu"))
    step = make_train_step(G, W, cfg, tcfg)
    for _ in range(3):
        jstate, jl = jstep(jstate)
        state, loss = step(state)
        assert abs(float(loss) - float(jl)) <= BF16_REL * abs(float(jl))


@pytest.mark.parametrize("phys_weight", [0.0, 0.3])
def test_three_bf16_fit_steps_match_jax(phys_weight):
    """fit_field with precision="bf16" on the mega engine: K6 bf16 once a
    step (and K4 bf16 for the composite), against JAX's same config."""
    cfg = MLPGridConfig(dims=MLPDims(H=32))
    sigma, u = _target(G_FIT)
    tcfg = TrainConfig(steps=3, seed=2, learning_rate=3e-3, precision="bf16")
    _, lp = ff.fit_field(G_FIT, cfg, [ff.target_from_arrays(sigma, u, T, device="cpu")], tcfg,
                         phys_weight=phys_weight, engine="mega", device="cpu")
    _, lj = jff.fit_field(_jax(G_FIT), _jax(cfg), [jff.target_from_arrays(sigma, u, T)], _jax(tcfg),
                          phys_weight=phys_weight, engine="mega", interpret=True)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=BF16_REL)


# ---------------------------------------------------------------- f32_high, bf16x3


def _k2(tp, cfg, tier):
    return [kmlp.generate_fields_fused(G, cfg, tp, T, tier)]


def _k3(tp, cfg, tier):
    return list(kmega.mega_loss_pipeline(G, W, cfg, tp, T, tier))


def _k4(tp, cfg, tier):
    loss, (gp, gt) = kbwd.mega_loss_and_grad(G, W, cfg, tp, T, tier)
    return [loss, gt, *(gp[k] for k in sorted(gp))]


def _k6(tp, cfg, tier):
    sigma, u = _target(G_FIT)
    loss, (gp, gt) = kfit.fit_loss_and_grad(G_FIT, cfg, tp, kfit.pack_target(G_FIT, sigma, u), T, W, tier)
    return [loss, gt, *(gp[k] for k in sorted(gp))]


_ROUTED = {("K2", "f32_high"): _k2, ("K3", "f32_high"): _k3, ("K3", "bf16x3"): _k3, ("K4", "f32_high"): _k4,
           ("K4", "bf16x3"): _k4, ("K6", "f32_high"): _k6, ("K6", "bf16x3"): _k6}


@pytest.mark.parametrize("kernel,tier", list(_ROUTED), ids=[f"{k}-{t}" for k, t in _ROUTED])
def test_routed_tiers_are_the_f32_result_bit_for_bit(kernel, tier):
    cfg, _, tp = _setup(32)
    fn = _ROUTED[(kernel, tier)]
    got = fn(tp, cfg, tier)
    ref = fn(tp, cfg, "f32")
    if kernel == "K2":
        got, ref = [torch.cat([x.reshape(-1) for x in got[0]])], [torch.cat([x.reshape(-1) for x in ref[0]])]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("kernel,tier", [("K3", "f32_high"), ("K3", "bf16x3"), ("K4", "f32_high"),
                                         ("K4", "bf16x3"), ("K6", "f32_high"), ("K6", "bf16x3"),
                                         ("K2", "f32_high")])
def test_routed_tiers_match_jax_at_the_f32_tolerances(kernel, tier):
    """JAX computes these tiers in f32 arithmetic (f32 operands at HIGHEST
    precision, or the f32 VPU arm): the port's f32 kernels meet them at
    the f32 tests' tolerances (K2 MLP_INFER_REL, K3 1e-5, K4 loss 5e-6 and
    gradients 1e-4, K6 loss 1e-6 and leaves 2e-5)."""
    cfg, jp, tp = _setup(32)
    if kernel == "K2":
        ref = _fields_np(jpmlp.generate_fields_fused(_jax(G), _jax(cfg), jp, T, tier, True))
        assert _rel(_fields_np(kmlp.generate_fields_fused(G, cfg, tp, T, tier)), ref) <= MLP_INFER_REL
    elif kernel == "K3":
        ref = jmega.mega_loss_pipeline(_jax(G), _jax(W), _jax(cfg), jp, T, tier, True)
        for a, b in zip(kmega.mega_loss_pipeline(G, W, cfg, tp, T, tier), ref):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
    elif kernel == "K4":
        loss, (gp, _) = kbwd.mega_loss_and_grad(G, W, cfg, tp, T, tier)
        jl, (jgp, _) = jmega_lg(_jax(G), _jax(W), _jax(cfg), jp, jnp.float32(T), tier, True)
        assert abs(float(loss) - float(jl)) <= 5e-6 * abs(float(jl))
        assert _rel(_cat({k: v.numpy() for k, v in gp.items()}), _cat(jgp)) <= 1e-4
    else:
        sigma, u = _target(G_FIT)
        loss, (gp, _) = kfit.fit_loss_and_grad(G_FIT, cfg, tp, kfit.pack_target(G_FIT, sigma, u), T, W, tier)
        jtarget = jfit.pack_target(_jax(G_FIT), jnp.asarray(sigma), jnp.asarray(u))
        jl, (jgp, _) = jfit.fit_loss_and_grad(_jax(G_FIT), _jax(cfg), jp, jtarget, T, _jax(W), tier, True)
        assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
        for k in gp:
            np.testing.assert_allclose(gp[k].numpy(), np.asarray(jgp[k]), rtol=2e-5, atol=1e-7)


def test_unported_and_unknown_tiers_raise():
    cfg, _, tp = _setup(8)
    with pytest.raises(ValueError, match="K1: .*residuals_fused_packed_bf16"):
        _build.check_precision("bf16", "K1")
    with pytest.raises(ValueError, match="unknown precision"):
        kmlp.generate_fields_fused(G, cfg, tp, T, "tf32")
    with pytest.raises(ValueError, match="unknown precision"):
        kbwd.mega_loss_and_grad(G, W, cfg, tp, T, "f32_fastbwd")


def test_bf16_gates_are_their_own():
    """Each bf16 kernel has its own shared-memory limit on H, worked out
    from its layout (the tops the gates' errors name); the f32 tops stay."""
    assert _build.gate_top(lambda h: kmlp.mlp_fits(h, "bf16")) == 2416
    assert _build.gate_top(lambda h: kmlp.mlp_fits(h, "bf16x3")) == 2064
    assert _build.gate_top(lambda h: kmega.mega_fwd_fits(G, h, "bf16")) == 1904
    assert _build.gate_top(lambda h: kbwd.mega_fits(G, h, "bf16")) == 1360
    assert _build.gate_top(lambda h: kfit.fit_fits(h, "bf16")) == 1600
    assert _build.gate_top(kmlp.mlp_fits) == 3632
    assert _build.gate_top(lambda h: kmega.mega_fwd_fits(G, h)) == 1908
    assert _build.gate_top(lambda h: kbwd.mega_fits(G, h)) == 1300
    assert _build.gate_top(kfit.fit_fits) == 1724


@pytest.mark.parametrize("h,phys_weight,gate", [(1620, 0.0, r"K6 \(bf16\) H <= 1600"),
                                                (1400, 0.3, r"K4 \(bf16\) H <= 1360")])
def test_auto_fit_engine_on_the_card_never_runs_bf16_in_float32(h, phys_weight, gate):
    """fit_field's "auto" engine with bf16 params on the card takes the bf16
    kernels or raises naming the gate they miss: the xla engine computes in
    float32. Below the gates it takes them; in f32 above them it still takes
    xla (the same arithmetic); on the CPU it takes xla, as the JAX package
    does off a TPU."""
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    with pytest.raises(ValueError, match=gate):
        ff._resolve_fit_engine("auto", G_FIT, cfg, phys_weight, on_card=True, precision="bf16")
    with pytest.raises(ValueError, match=gate):
        ff._resolve_fit_engine("mega", G_FIT, cfg, phys_weight, precision="bf16")
    assert ff._resolve_fit_engine("auto", G_FIT, cfg, phys_weight, on_card=False, precision="bf16") == "xla"
    assert ff._resolve_fit_engine("xla", G_FIT, cfg, phys_weight, on_card=True, precision="bf16") == "xla"
    small = MLPGridConfig(dims=MLPDims(H=128))
    assert ff._resolve_fit_engine("auto", G_FIT, small, phys_weight, on_card=True, precision="bf16") == "mega"
    wide = MLPGridConfig(dims=MLPDims(H=1800))
    assert ff._resolve_fit_engine("auto", G_FIT, wide, phys_weight, on_card=True, precision="f32") == "xla"


@pytest.mark.parametrize("h,tier,one_call", [(1340, "bf16", True), (1340, "f32", False), (1400, "bf16", False)])
def test_fused_training_step_gates_k4_by_its_tier(monkeypatch, h, tier, one_call):
    """make_train_step(use_fused=True) takes the one-call K4 path within the
    gate of its tier (bf16 H <= 1360, f32 H <= 1300), else autograd of the
    K3 / K4 loss; either way the tier reaches the kernels, whose wrappers
    raise above their gates on the card."""
    from phys_autodiff_tpu_torch.train import loop as tloop

    calls = []

    def one(g, w, mcfg, params, t, precision):
        calls.append(("mega_loss_and_grad", precision))
        return torch.zeros(()), ({k: torch.zeros_like(v) for k, v in params.items()}, None)

    def staged(g, w, mcfg, params, t, use_fused, remat, precision):
        calls.append(("loss_fn", use_fused, precision))
        return sum(params[k].sum() for k in params) * 0.0

    monkeypatch.setattr(tloop, "mega_loss_and_grad", one)
    monkeypatch.setattr(tloop, "loss_fn", staged)
    cfg = MLPGridConfig(dims=MLPDims(H=h))
    tcfg = TrainConfig(use_fused=True, precision=tier)
    make_train_step(G_FIT, W, cfg, tcfg)(state_from_params(tcfg, ff.init_any(cfg, seed=0, device="cpu")))
    assert calls == [("mega_loss_and_grad", tier) if one_call else ("loss_fn", True, tier)]
