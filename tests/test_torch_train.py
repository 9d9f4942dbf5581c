"""The port's training loop (phys_autodiff_tpu_torch/train) vs the JAX
package's: the reference's M6 criterion, trajectories from shared params,
the optax schedules, and npz checkpoints that cross between the packages.

Grid, model and step budget of tests/test_train.py (16x16x8, H=32).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.models import fields as jfields
from phys_autodiff_tpu.models import hash_encoder as jhash
from phys_autodiff_tpu.models import mlp as jmlp
from phys_autodiff_tpu.models import ngp as jngp
from phys_autodiff_tpu.train import checkpoint as jckpt
from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import CoordNorm, GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_loss_and_grad
from phys_autodiff_tpu_torch.models import fields as tfields
from phys_autodiff_tpu_torch.models import mlp as tmlp
from phys_autodiff_tpu_torch.models import ngp as tngp
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.train import (
    TrainConfig,
    checkpoint,
    fit,
    fit_scan,
    init_state,
    loss_fn,
    make_generic_train_step,
    make_ngp_train_step,
    make_schedule,
    make_train_step,
    state_from_params,
)

torch.set_num_threads(1)

G = GridSpec(nx=16, ny=16, nz=8, hx=0.4, hy=0.4, hz=0.8, dt=1e-2)
W = PhysWeights()
MCFG = MLPGridConfig(dims=MLPDims(H=32))
CPU = "cpu"


_JAX_MODULES = (jconfig, jhash, jngp)


def _jax(x):
    """The JAX package's config with the field values of the port's config x
    (each package takes its own config classes)."""
    if isinstance(x, CoordNorm):
        return jconfig.CoordNorm(x.value)
    if not dataclasses.is_dataclass(x):
        return x
    mod = next(m for m in _JAX_MODULES if hasattr(m, type(x).__name__))
    fields = {f.name: _jax(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return getattr(mod, type(x).__name__)(**fields)


def _params_np(state):
    return tngp.params_to_numpy(state.params)


def _cat(p):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(p)])


def _moved_rel(p, ref, p0):
    """Relative distance of two trajectories' displacements from the shared
    start p0: |(p - p0) - (ref - p0)| / |ref - p0|. Adam moves every
    component by about lr whatever its gradient, so a component whose
    gradient is near 0 carries f32 gradient noise into a full step: an
    elementwise bound would grade that noise, the displacement norm does
    not."""
    d, d_ref = _cat(p) - _cat(p0), _cat(ref) - _cat(p0)
    return np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)


def test_loss_drops_90_percent():
    """The reference's M6 acceptance criterion (REQUIREMENT.md:164-169)."""
    cfg = TrainConfig(steps=300, learning_rate=3e-3, t=0.25, seed=1, log_every=50)
    _, history, _ = fit(G, W, MCFG, cfg, device=CPU)
    first, last = history[0][1], history[-1][1]
    assert last <= 0.1 * first, f"loss only dropped {first} -> {last}"
    assert np.isfinite(last)


def test_adamw_cosine_warmup_clip_trains():
    cfg = TrainConfig(
        steps=300, learning_rate=3e-3, t=0.25, seed=1, log_every=50, optimizer="adamw",
        weight_decay=1e-4, grad_clip=1.0, lr_schedule="cosine", warmup_steps=30,
    )
    _, history, _ = fit(G, W, MCFG, cfg, device=CPU)
    assert history[-1][1] <= 0.1 * history[0][1]


def test_train_step_deterministic():
    cfg = TrainConfig(steps=1, seed=7)
    step = make_train_step(G, W, MCFG, cfg)
    s1, l1 = step(init_state(cfg, MCFG, device=CPU))
    s2, l2 = step(init_state(cfg, MCFG, device=CPU))
    assert float(l1) == float(l2) and s1.step == s2.step == 1
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k])


def test_uniform_t_sampling_changes_loss():
    cfg = TrainConfig(steps=1, seed=3, t_sampling="uniform")
    step = make_train_step(G, W, MCFG, cfg)
    state = init_state(cfg, MCFG, device=CPU)
    state, l1 = step(state)
    state, l2 = step(state)
    assert float(l1) != float(l2)


def test_fused_step_agrees_with_autograd_step():
    """use_fused=True (one mega_loss_and_grad per step: K4's plain version
    on the CPU) against plain autograd of the staged loss, 20 adam steps
    from the same params: losses within 1e-5 relative, displacements 1e-3."""
    runs = {}
    for fused in (False, True):
        cfg = TrainConfig(steps=20, learning_rate=1e-3, seed=4, use_fused=fused)
        step = make_train_step(G, W, MCFG, cfg)
        state, losses = init_state(cfg, MCFG, device=CPU), []
        p0 = _params_np(state)
        for _ in range(20):
            state, loss = step(state)
            losses.append(float(loss))
        runs[fused] = (np.array(losses), _params_np(state))
    np.testing.assert_allclose(runs[True][0], runs[False][0], rtol=1e-5)
    assert _moved_rel(runs[True][1], runs[False][1], p0) < 1e-3


def test_fused_loss_fn_backward_is_the_backward_kernel():
    """loss_fn(use_fused=True): K3 forward, K4 backward (autograd.Function)
    whose gradients, t included, are mega_loss_and_grad's."""
    params = tmlp.init_params(MCFG.dims, seed=2, device=CPU)
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    t = torch.tensor(0.3, requires_grad=True)
    loss = loss_fn(G, W, MCFG, p, t, use_fused=True)
    (2.0 * loss).backward()
    l_ref, (gp, gt) = mega_loss_and_grad(G, W, MCFG, params, 0.3)
    assert abs(float(loss.detach()) - float(l_ref)) <= 1e-6 * abs(float(l_ref))
    for k in gp:
        torch.testing.assert_close(p[k].grad, 2.0 * gp[k], rtol=1e-6, atol=0)
    torch.testing.assert_close(t.grad, 2.0 * gt, rtol=1e-6, atol=0)


TRAJECTORY_CFGS = {
    "adam": dict(optimizer="adam", learning_rate=3e-3),
    "sgd": dict(optimizer="sgd", learning_rate=0.05),
    "adamw_clip_cosine": dict(
        optimizer="adamw", learning_rate=3e-3, weight_decay=1e-2, grad_clip=0.5,
        lr_schedule="cosine", warmup_steps=2, steps=5, lr_final_scale=0.1,
    ),
}


@pytest.mark.parametrize("name", list(TRAJECTORY_CFGS))
def test_five_step_trajectory_matches_jax(name):
    """Five steps from shared params through both packages' make_train_step:
    losses within 1e-5 relative at every step, and the displacement of the
    params from the start within 1e-3 relative (see _moved_rel)."""
    kw = TRAJECTORY_CFGS[name]
    jcfg = jloop.TrainConfig(seed=5, **kw)
    jstate = jloop.init_state(jcfg, _jax(MCFG))
    state = state_from_params(TrainConfig(seed=5, **kw), tmlp.params_from_jax(
        {k: np.asarray(v) for k, v in jstate.params.items()}, device=CPU))
    jstep = jloop.make_train_step(_jax(G), _jax(W), _jax(MCFG), jcfg)
    step = make_train_step(G, W, MCFG, TrainConfig(seed=5, **kw))
    p0 = _params_np(state)
    for _ in range(5):
        jstate, jl = jstep(jstate)
        state, l = step(state)
        assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _moved_rel(_params_np(state), jstate.params, p0) < 1e-3


@pytest.mark.parametrize(
    "kw",
    [
        dict(learning_rate=1e-2),
        dict(learning_rate=1e-2, warmup_steps=7),
        dict(learning_rate=1e-2, lr_schedule="cosine", warmup_steps=10, steps=100, lr_final_scale=0.1),
        dict(learning_rate=3e-3, lr_schedule="cosine", steps=40),
    ],
    ids=["constant", "constant-warmup", "cosine-warmup", "cosine"],
)
def test_learning_rate_of_each_step_is_the_optax_schedule(kw):
    """The lr of the k-th update (k from 0: the first update of a warmup
    has lr 0), within 1e-6 relative plus 1e-7 of the peak: optax evaluates
    in float32, and its cos(pi c / n) near -1 rounds at about 1e-7."""
    sched = jloop.make_schedule(jloop.TrainConfig(**kw))
    ours = make_schedule(TrainConfig(**kw))
    peak = kw["learning_rate"]
    for k in range(0, 120):
        ref = float(sched(k)) if callable(sched) else float(sched)
        assert abs(ours(k) - ref) <= 1e-6 * abs(ref) + 1e-7 * peak, (k, ours(k), ref)
    if kw.get("warmup_steps"):
        assert ours(0) == 0.0


def test_first_warmup_update_leaves_the_params():
    cfg = TrainConfig(optimizer="sgd", learning_rate=0.1, warmup_steps=3, seed=2)
    step = make_train_step(G, W, MCFG, cfg)
    state = init_state(cfg, MCFG, device=CPU)
    before = _params_np(state)
    state, _ = step(state)
    for k, v in _params_np(state).items():
        np.testing.assert_array_equal(v, before[k])
    state, _ = step(state)
    assert not np.array_equal(_params_np(state)["W1"], before["W1"])


def test_grad_clip_caps_first_update():
    """With SGD the first update is -lr * clipped_grad: its global norm is
    at most lr * clip (optax's clip has no epsilon)."""
    clip = 0.01
    cfg = TrainConfig(steps=1, learning_rate=1.0, optimizer="sgd", grad_clip=clip, seed=3)
    state0 = init_state(cfg, MCFG, device=CPU)
    before = _params_np(state0)
    state1, _ = make_train_step(G, W, MCFG, cfg)(state0)
    after = _params_np(state1)
    gnorm = np.sqrt(sum(np.sum((after[k] - before[k]).astype(np.float64) ** 2) for k in after))
    assert gnorm <= clip * cfg.learning_rate * (1 + 1e-5), gnorm
    assert gnorm >= clip * cfg.learning_rate * (1 - 1e-3), gnorm


def test_fit_scan_matches_fit():
    cfg = TrainConfig(steps=20, learning_rate=1e-3, seed=4, log_every=5)
    s1, h1, _ = fit(G, W, MCFG, cfg, device=CPU)
    s2, h2, _ = fit_scan(G, W, MCFG, cfg, device=CPU)
    assert [s for s, _ in h2] == [5, 10, 15, 20]
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k])
    assert h1[-1] == h2[-1]


def test_remat_training_matches_plain():
    runs = []
    for remat in (False, True):
        cfg = TrainConfig(steps=3, learning_rate=1e-3, seed=6, remat=remat)
        step, state = make_train_step(G, W, MCFG, cfg), init_state(cfg, MCFG, device=CPU)
        for _ in range(3):
            state, loss = step(state)
        runs.append(float(loss))
    assert abs(runs[0] - runs[1]) <= 1e-6 * max(1.0, abs(runs[0]))


def test_matmul_precision_bf16_trains():
    runs = []
    for mp in (None, "bfloat16"):
        cfg = TrainConfig(steps=10, learning_rate=1e-3, seed=8, matmul_precision=mp)
        step, state = make_train_step(G, W, MCFG, cfg), init_state(cfg, MCFG, device=CPU)
        for _ in range(10):
            state, loss = step(state)
        runs.append(float(loss))
    assert np.isfinite(runs[1]) and abs(runs[1] - runs[0]) <= 0.05 * max(abs(runs[0]), 1e-3)
    assert torch.get_float32_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_checkpoint_roundtrip_and_resume(tmp_path, optimizer):
    cfg = TrainConfig(steps=3, seed=2, optimizer=optimizer, t_sampling="uniform")
    step = make_train_step(G, W, MCFG, cfg)
    state = init_state(cfg, MCFG, device=CPU)
    for _ in range(3):
        state, _ = step(state)
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save_npz(path, state, meta={"H": 32})
    restored = checkpoint.restore_npz(path, init_state(cfg, MCFG, device=CPU), expect_meta={"H": 32})
    assert restored.step == 3
    for k in state.params:
        assert torch.equal(state.params[k], restored.params[k])
    # resume: one more step from restored == one more step from the original
    s1, l1 = step(state)
    s2, l2 = step(restored)
    assert float(l1) == float(l2)
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k])


def test_params_checkpoint_crosses_both_ways(tmp_path):
    jparams = jmlp.init_params(_jax(MCFG.dims), seed=9)
    tparams = tmlp.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device=CPU)
    # JAX writes, the port reads
    jpath = os.path.join(tmp_path, "from_jax")
    jckpt.save_npz(jpath, jparams, meta={"norm": "m11"})
    got = checkpoint.restore_npz(jpath, tparams, expect_meta={"norm": "m11"})
    for k in jparams:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jparams[k]))
    assert checkpoint.read_manifest(jpath)["treedef"] == "PyTreeDef({'W1': *, 'W2': *, 'b1': *, 'b2': *})"
    # the port writes, JAX reads
    tpath = os.path.join(tmp_path, "from_port")
    moved = {k: v + 1.0 for k, v in tparams.items()}
    checkpoint.save_npz(tpath, moved, extra={"step": 4})
    back = jckpt.restore_npz(tpath, jparams)
    for k in jparams:
        np.testing.assert_array_equal(np.asarray(back[k]), moved[k].numpy())
    assert jckpt.read_manifest(tpath)["extra"] == {"step": 4}


def test_restore_checks_the_structure_and_meta(tmp_path):
    import warnings

    tree = {"a": torch.arange(3.0), "b": (torch.ones(2, 2), None)}
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save_npz(path, tree, meta={"v": 1})
    with pytest.raises(ValueError, match="treedef"):
        checkpoint.restore_npz(path, {"a": torch.zeros(3), "c": (torch.zeros(2, 2), None)})
    with pytest.raises(ValueError, match="meta"):
        checkpoint.restore_npz(path, tree, expect_meta={"v": 2})
    # the same structure string as jax.tree_util
    assert checkpoint.read_manifest(path)["treedef"] == str(
        jax.tree_util.tree_structure({"a": 0, "b": (0, None)}))
    # strip the manifest and the sidecar: refused, unless allow_unvalidated
    with np.load(path + ".npz") as data:
        leaves = {k: data[k] for k in data.files if k.startswith("leaf_")}
    np.savez(path + ".npz", **leaves)
    os.remove(path + ".tree.json")
    with pytest.raises(ValueError, match="no embedded manifest"):
        checkpoint.restore_npz(path, tree)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        back = checkpoint.restore_npz(path, tree, expect_meta={"v": 1}, allow_unvalidated=True)
    assert "cannot be verified" in " | ".join(str(r.message) for r in rec)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1] is None


def test_leaf_dtypes_survive_both_restores(tmp_path):
    """Scalars and int leaves keep their dtype through the port's restore."""
    tree = {"w": torch.tensor([1.5, -2.0]), "n": torch.tensor(7)}
    path = os.path.join(tmp_path, "s")
    checkpoint.save_npz(path, tree)
    jtree = jckpt.restore_npz(path, {"n": jnp.int64(0) if jax.config.x64_enabled else jnp.int32(0),
                                     "w": jnp.zeros(2)})
    assert float(jtree["w"][1]) == -2.0 and int(jtree["n"]) == 7
    back = checkpoint.restore_npz(path, {"w": torch.zeros(2), "n": torch.tensor(0)})
    assert back["n"].dtype == torch.int64 and torch.equal(back["w"], tree["w"])


# ---------------------------------------------------------------------------
# The encoded-field (NGP) step and the generic step
# ---------------------------------------------------------------------------

NGP_G = GridSpec(nx=128, ny=8, nz=6, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
NGP_CFG = tngp.NGPFieldConfig(
    encoding=HashEncodingConfig(num_levels=3, base_resolution=4, max_resolution=8, log2_table_size=7,
                                dense_oversubscribed=True),
    hidden=16,
)


def _ngp_params(seed=7):
    """Both packages' params, conditioned as tests/test_mega_ngp.py does
    (paper-init tables leave every gradient at the f32 noise floor)."""
    jp = jngp.init_ngp_params(_jax(NGP_CFG), seed=seed)
    rng = np.random.Generator(np.random.MT19937(21))
    jp["tables"] = jax.tree_util.tree_map(lambda a: a * 2000.0, jp["tables"])
    jp["b1"] = jnp.asarray(rng.standard_normal(jp["b1"].shape) * 0.3, jnp.float32)
    jp["b2"] = jnp.asarray(rng.standard_normal(jp["b2"].shape) * 0.3, jnp.float32)
    return jp, tngp.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device=CPU)


NGP_TRAJECTORIES = {
    "adam": dict(optimizer="adam", learning_rate=1e-3),
    "adamw_clip": dict(optimizer="adamw", learning_rate=1e-3, weight_decay=1e-2, grad_clip=0.05),
}


@pytest.mark.parametrize("name", list(NGP_TRAJECTORIES))
def test_ngp_three_step_trajectory_matches_jax(name):
    """Three steps of make_ngp_train_step (backward "auto": K5, whose plain
    version runs on the CPU) against the JAX make_ngp_train_step(backward=
    "xla") from shared params: losses within 1e-5 relative at every step,
    the params' displacement within 1e-3 (see _moved_rel)."""
    kw = NGP_TRAJECTORIES[name]
    jp, tp = _ngp_params()
    jstep, jstate = jloop.make_ngp_train_step(
        _jax(NGP_G), _jax(W), _jax(NGP_CFG), jloop.TrainConfig(seed=5, **kw), jp, backward="xla")
    step, state = make_ngp_train_step(NGP_G, W, NGP_CFG, TrainConfig(seed=5, **kw), tp)
    p0 = _params_np(state)
    for _ in range(3):
        jstate, jl = jstep(jstate)
        state, l = step(state)
        assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))
    assert state.step == 3
    assert _moved_rel(_params_np(state), jstate.params, p0) < 1e-3


def test_ngp_mega_and_autograd_steps_agree():
    """backward="mega" (one K5 call a step) against backward="xla" (autograd
    through the fields, fused and staged physics loss) in the port."""
    _, tp = _ngp_params()
    cfg = TrainConfig(seed=1, learning_rate=1e-3)
    runs = {}
    for backward in ("mega", "xla"):
        step, state = make_ngp_train_step(NGP_G, W, NGP_CFG, cfg, tp, backward=backward)
        losses = []
        for _ in range(2):
            state, l = step(state)
            losses.append(float(l))
        runs[backward] = (losses, _params_np(state))
    np.testing.assert_allclose(runs["mega"][0], runs["xla"][0], rtol=1e-5)
    assert _moved_rel(runs["mega"][1], runs["xla"][1], tngp.params_to_numpy(tp)) < 1e-3
    with pytest.raises(ValueError, match="backward"):
        make_ngp_train_step(NGP_G, W, NGP_CFG, cfg, tp, backward="slab")


@pytest.mark.parametrize("physics_loss", ["staged", "fused"])
def test_generic_step_with_the_coordinate_mlp_matches_jax(physics_loss):
    """make_generic_train_step on the coordinate MLP's generate_fields:
    three adam steps against the JAX generic step (staged loss)."""
    jparams = jmlp.init_params(_jax(MCFG.dims), seed=3)
    tparams = tmlp.params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, device=CPU)
    jstep, jstate = jloop.make_generic_train_step(
        _jax(G), _jax(W), lambda p, t: jfields.generate_fields(_jax(G), _jax(MCFG), p, t, G.dt),
        jloop.TrainConfig(seed=2, learning_rate=3e-3), jparams, physics_loss="staged")
    step, state = make_generic_train_step(
        G, W, lambda p, t: tfields.generate_fields(G, MCFG, p, t, G.dt), TrainConfig(seed=2, learning_rate=3e-3),
        tparams, physics_loss=physics_loss)
    p0 = _params_np(state)
    for _ in range(3):
        jstate, jl = jstep(jstate)
        state, l = step(state)
        assert abs(float(l) - float(jl)) <= 1e-5 * abs(float(jl))
    assert _moved_rel(_params_np(state), jstate.params, p0) < 1e-3


def test_ngp_checkpoint_crosses_both_ways_with_its_meta(tmp_path):
    jp, tp = _ngp_params(seed=4)
    meta = tngp.checkpoint_meta(NGP_CFG)
    assert meta == jngp.checkpoint_meta(_jax(NGP_CFG))
    # JAX writes, the port reads
    jpath = os.path.join(tmp_path, "from_jax")
    jckpt.save_npz(jpath, jp, meta=jngp.checkpoint_meta(_jax(NGP_CFG)))
    got = checkpoint.restore_npz(jpath, tp, expect_meta=meta)
    for a, b in zip(jax.tree_util.tree_leaves(tngp.params_to_numpy(got)), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the port writes, JAX reads
    tpath = os.path.join(tmp_path, "from_port")
    moved = jax.tree_util.tree_map(lambda x: x + 1.0, tp)
    checkpoint.save_npz(tpath, moved, meta=meta)
    back = jckpt.restore_npz(tpath, jp, expect_meta=jngp.checkpoint_meta(_jax(NGP_CFG)))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tngp.params_to_numpy(moved))):
        np.testing.assert_array_equal(np.asarray(a), b)
    # another schedule's meta is refused
    other = tngp.checkpoint_meta(tngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=3), hidden=16))
    with pytest.raises(ValueError, match="meta"):
        checkpoint.restore_npz(tpath, tp, expect_meta=other)


def test_ngp_train_state_checkpoint_resumes(tmp_path):
    """A TrainState with nested params and Adam state round-trips in the
    port: one more step from the restored state equals one from the
    original."""
    _, tp = _ngp_params()
    cfg = TrainConfig(seed=3, learning_rate=1e-3, t_sampling="uniform")
    step, state = make_ngp_train_step(NGP_G, W, NGP_CFG, cfg, tp)
    for _ in range(2):
        state, _ = step(state)
    path = os.path.join(tmp_path, "ngp_state")
    checkpoint.save_npz(path, state, meta=tngp.checkpoint_meta(NGP_CFG))
    _, fresh = make_ngp_train_step(NGP_G, W, NGP_CFG, cfg, tp)
    restored = checkpoint.restore_npz(path, fresh, expect_meta=tngp.checkpoint_meta(NGP_CFG))
    assert restored.step == 2
    s1, l1 = step(state)
    s2, l2 = step(restored)
    assert float(l1) == float(l2)
    for a, b in zip(jax.tree_util.tree_leaves(_params_np(s1)), jax.tree_util.tree_leaves(_params_np(s2))):
        np.testing.assert_array_equal(a, b)
