"""The PyTorch port imports without jax and without the JAX package, keeps
its kernels behind CUDA tensors, puts its tensors on the card unless told
otherwise, and reports a missing CUDA toolkit clearly.

The machine with the card has no jax at all, and the port keeps its own
copies of what it needs from the JAX package, so every module of
phys_autodiff_tpu_torch (and chip_smoke.py) must load with both jax and
phys_autodiff_tpu blocked. CPU tensors take the plain versions, so the
launch counters stay at 0 here.
"""

import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch import cli, models, parallel
from phys_autodiff_tpu_torch.apps import euler, transport
from phys_autodiff_tpu_torch.kernels import _build, fit as kfit, mega, mega_bwd, mega_ngp, mlp as kmlp, residuals as kres
from phys_autodiff_tpu_torch.kernels import probe as kprobe, transport as ktr
from phys_autodiff_tpu_torch.ops import obstacles
from phys_autodiff_tpu_torch.models import encoders, fourier, hash_encoder, mlp, modelio, ngp
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.train import TrainConfig, fit, fit_field, fit_scan, init_state, loop, make_ngp_train_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
# any `import jax`, `import phys_autodiff_tpu` or `import phys_autodiff_tpu.x`
# now raises ImportError
sys.modules["jax"] = None
sys.modules["phys_autodiff_tpu"] = None
import phys_autodiff_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in ("kernels.mega_bwd", "kernels.mega_ngp", "kernels.fit", "train", "train.loop",
             "train.checkpoint", "train.slab_grad", "train.fit_field", "models.hash_encoder",
             "models.fourier", "models.encoders", "models.ngp", "models.sample", "models.modelio",
             "utils.config", "utils.tolerances", "utils.metrics", "utils.tree", "utils.export",
             "ref.oracle", "cli", "__main__", "apps", "apps.transport", "apps.euler", "apps.advect",
             "ops.diagnostics", "ops.projection", "ops.diffusion", "ops.obstacles", "ops.cg", "models.solenoidal",
             "kernels.transport", "kernels.probe", "parallel", "parallel.mesh", "parallel.sharded",
             "parallel.launch", "parallel.spectral", "entry", "train.resilient", "utils.checks", "utils.timing"):
    assert pkg.__name__ + "." + name in names, name
from phys_autodiff_tpu_torch.train import ResilienceConfig, fit_resilient
from phys_autodiff_tpu_torch.train.resilient import RunReport, default_failure_predicate
from phys_autodiff_tpu_torch.utils.checks import assert_all_finite, checked, guard_fields
from phys_autodiff_tpu_torch.utils.timing import annotate, trace
import chip_smoke
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "phys_autodiff_tpu") and sys.modules[k] is not None)
assert not loaded, loaded
print(len(names), "modules")
"""


def test_every_port_module_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    n = int(proc.stdout.split()[0])
    assert n >= 49, proc.stdout  # models, ops, kernels, ref, utils, train, apps, entry, cli


def test_port_sources_never_import_jax():
    """Neither jax nor the JAX package, in the port or in chip_smoke.py."""
    for path in [*(REPO / "phys_autodiff_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]), path
            assert not line.strip().startswith(("import jax.", "from jax.")), path
            assert words[:2] not in (["import", "phys_autodiff_tpu"], ["from", "phys_autodiff_tpu"]), path
            assert not line.strip().startswith(
                ("import phys_autodiff_tpu.", "from phys_autodiff_tpu.")), path
            assert "torch.compile" not in line, path


def test_cpu_tensors_take_the_plain_versions():
    _build.reset_launches()
    g = GridSpec(nx=8, ny=4, nz=3, hx=0.3, hy=0.3, hz=0.3, dt=1e-2)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=8))
    params = mlp.init_params(cfg.dims, seed=0, device="cpu")
    fields = kmlp.generate_fields_fused(g, cfg, params, 0.25)
    packed = kmlp.generate_fields_fused_packed(g, cfg, params, 0.25)
    kmlp.grid_infer_fused(g, cfg, params, 0.25)
    kres.residuals_fused(g, fields)
    kres.loss_forward_fused(g, w, fields)
    kres.loss_backward_fused(g, w, fields)
    kres.residuals_fused_packed(g, packed)
    kres.loss_forward_fused_packed(g, w, packed)
    kres.loss_backward_fused_packed(g, w, packed)
    kmlp.fused_loss_pipeline(g, w, cfg, params, 0.25)
    mega.mega_loss_pipeline(g, w, cfg, params, 0.25)
    mega_bwd.mega_loss_and_grad(g, w, cfg, params, 0.25)
    fit(g, w, cfg, TrainConfig(steps=2, use_fused=True), device="cpu")
    ncfg = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, log2_table_size=6, max_resolution=8,
                                                          dense_oversubscribed=True), hidden=8)
    nparams = ngp.init_ngp_params(ncfg, seed=0, device="cpu")
    mega_ngp.ngp_loss_and_grad(g, w, ncfg, nparams, 0.25)
    step, state = make_ngp_train_step(g, w, ncfg, TrainConfig(), nparams, backward="mega")
    step(state)
    target = kfit.pack_target(g, torch.zeros(g.shape), torch.zeros((3,) + g.shape))
    kfit.fit_loss_and_grad(g, cfg, params, target, 0.25)
    kfit.ngp_fit_loss_and_grad(g, ncfg, nparams, target, 0.25)
    fit_field.fit_field(g, ncfg, [fit_field.FitTarget(target[:, 0].reshape(g.shape), torch.zeros((3,) + g.shape), 0.25)],
                        TrainConfig(steps=1), params0=nparams, phys_weight=0.5, engine="mega")
    u = torch.full((3,) + g.shape, 0.5)
    transport.transport(g, torch.ones(g.shape), u, transport.TransportConfig(steps=2, scheme="maccormack"))
    ktr.transport_step_fused_pre(g, torch.ones(g.shape), ktr.transport_weights(g, u, 1e-2))
    ktr.transport_step_slab(g, torch.ones((2, g.nz + 2) + g.shape[1:]), torch.full((3, g.nz + 2) + g.shape[1:], 0.5),
                            1e-2)
    euler.rollout(g, euler.EulerState(torch.ones(g.shape), u), euler.EulerConfig(steps=1, advection="maccormack"))
    kprobe.probe(torch.zeros(96, 128))
    # the bf16 tier's wrappers too (their counters are their own)
    kmlp.fused_loss_pipeline(g, w, cfg, params, 0.25, "bf16")
    kmlp.grid_infer_fused(g, cfg, params, 0.25, "bf16x3")
    mega.mega_loss_pipeline(g, w, cfg, params, 0.25, "bf16")
    mega_bwd.mega_loss_and_grad(g, w, cfg, params, 0.25, "bf16")
    kfit.fit_loss_and_grad(g, cfg, params, target, 0.25, w, "bf16")
    # the NGP tiers and K1's bf16-I/O entry points
    for tier in ("bf16", "f32_fastbwd"):
        mega_ngp.ngp_loss_and_grad(g, w, ncfg, nparams, 0.25, tier)
    kfit.ngp_fit_loss_and_grad(g, ncfg, nparams, target, 0.25, w, "bf16")
    kres.residuals_fused_packed_bf16(g, packed.to(torch.bfloat16))
    kres.residuals_fused_packed_mixed_out(g, packed)
    # the shard-local builds (K4-K7 on a shard's rows; the halo rows of K5's encoding)
    tabs = kmlp.fold_tables(g, cfg, params, [0.24, 0.25, 0.26])
    enc = encoders.encode_grid_zcf(ncfg.encoding, nparams["tables"], g)
    head = tuple(nparams[k] for k in ("W1", "b1", "W2", "b2"))
    ts = torch.tensor([0.24, 0.25, 0.26])
    for tier in ("f32", "bf16"):
        mega_bwd.table_loss_and_grad_shard(g, w, *tabs, 1, 1, tier)
        kfit.fit_table_loss_and_grad_shard(g, w, *kmlp.fold_tables(g, cfg, params, [0.25]), target[1:2], 1, 1, tier)
        kfit.ngp_fit_head_loss_and_grad_shard(g, w, enc[1:2], *head, torch.tensor(0.25), target[1:2], 1, 1, tier)
    for tier in ("f32", "bf16", "f32_fastbwd"):
        mega_ngp.head_loss_and_grad_shard(g, w, encoders.encode_grid_zcf_rows(
            ncfg.encoding, nparams["tables"], g, mega_bwd.halo_rows(g, 1, 1)), *head, ts, 1, 1, tier)
    assert _build.LAUNCHES == {"residuals": 0, "mlp": 0, "mega": 0, "mega_bwd": 0, "mega_ngp": 0, "fit": 0,
                               "fit_ngp": 0, "transport": 0, "transport_pre": 0, "probe": 0, "mlp bf16": 0,
                               "mlp bf16x3": 0, "mega bf16": 0, "mega_bwd bf16": 0, "fit bf16": 0,
                               "mega_ngp bf16": 0, "mega_ngp f32_fastbwd": 0, "fit_ngp bf16": 0,
                               "residuals bf16": 0, "residuals mixed_out": 0, "mega_bwd shard": 0,
                               "mega_bwd bf16 shard": 0, "mega_ngp shard": 0, "mega_ngp bf16 shard": 0,
                               "mega_ngp f32_fastbwd shard": 0, "fit shard": 0, "fit bf16 shard": 0,
                               "fit_ngp shard": 0, "fit_ngp bf16 shard": 0, "transport slab": 0,
                               "hash_encode": 0, "hash_encode pullback": 0, "hash_encode bf16": 0,
                               "hash_encode bf16 pullback": 0}


def test_build_raises_clearly_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib()
    assert not (tmp_path / "build").exists()


def test_build_keys_the_library_by_its_sources():
    names = [p.name for p in _build.sources()]
    assert names == ["fit.cu", "fit_ngp.cu", "hash_encode.cu", "mega.cu", "mega_bwd.cu", "mega_ngp.cu", "mlp.cu",
                     "probe.cu", "residuals.cu", "transport.cu"]
    key = _build._source_hash()
    assert len(key) == 16 and key == _build._source_hash()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("precision", ["bf16", "bf16x3", "f32_high"])
def test_unported_precision_tiers_raise(precision):
    """Every tier of the JAX package runs: K2-K4 (f32_high, and bf16x3
    outside K2, as the f32 result to the bit; bf16 and K2's bf16x3 rounded),
    K1's f32 wrappers (the f32 names as f32; "bf16" raises ValueError naming
    K1's bf16-I/O entry points, its tiers in the JAX package) and the NGP
    kernel K5 (bf16, f32_fastbwd)."""
    g = GridSpec(nx=8, ny=4, nz=3)
    cfg = MLPGridConfig(dims=MLPDims(H=8))
    params = mlp.init_params(cfg.dims, seed=0, device="cpu")
    packed = torch.randn((12,) + g.shape, generator=torch.Generator().manual_seed(0))
    if precision == "bf16":
        with pytest.raises(ValueError, match="residuals_fused_packed_bf16"):
            kres.residuals_fused_packed(g, packed, precision)
    else:
        assert torch.equal(kres.residuals_fused_packed(g, packed, precision), kres.residuals_fused_packed(g, packed))
    same_as_f32 = precision == "f32_high"
    calls = {
        "K2": lambda p: torch.stack(kmlp.generate_fields_fused(g, cfg, params, 0.1, p)[:3]),
        "K3": lambda p: torch.stack(mega.mega_loss_pipeline(g, PhysWeights(), cfg, params, 0.1, p)),
        "K4": lambda p: mega_bwd.mega_loss_and_grad(g, PhysWeights(), cfg, params, 0.1, p)[1][0]["W2"],
    }
    for kernel, call in calls.items():
        got, f32 = call(precision), call("f32")
        assert bool(torch.isfinite(got).all())
        equal = same_as_f32 or (precision == "bf16x3" and kernel != "K2")
        assert torch.equal(got, f32) == equal, kernel
    if precision == "bf16":
        ncfg = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, log2_table_size=6), hidden=8)
        nparams = ngp.init_ngp_params(ncfg, device="cpu")
        f32 = mega_ngp.ngp_loss_and_grad(g, PhysWeights(), ncfg, nparams, 0.1)
        for tier in ("bf16", "f32_fastbwd"):
            loss, (grads, _) = mega_ngp.ngp_loss_and_grad(g, PhysWeights(), ncfg, nparams, 0.1, tier)
            assert bool(torch.isfinite(loss)) and not torch.equal(grads["W1"], f32[1][0]["W1"])


def _bf16_calls():
    """(kernel, the wrapper called with precision="bf16") for every wrapper
    that checks the precision tier."""
    g = GridSpec(nx=8, ny=4, nz=3)
    w = PhysWeights()
    cfg = MLPGridConfig(dims=MLPDims(H=8))
    params = mlp.init_params(cfg.dims, seed=0, device="cpu")
    ncfg = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, log2_table_size=6), hidden=8)
    nparams = ngp.init_ngp_params(ncfg, device="cpu")
    target = torch.zeros(g.nz, 4, g.ny * g.nx)
    fields = kmlp.generate_fields_fused(g, cfg, params, 0.1)
    return {
        "K1 residuals_fused": ("K1", lambda: kres.residuals_fused(g, fields, "bf16")),
        "K1 residuals_fused_packed": ("K1", lambda: kres.residuals_fused_packed(g, torch.zeros((12,) + g.shape),
                                                                               "bf16")),
        "K2 generate_fields_fused": ("K2", lambda: kmlp.generate_fields_fused(g, cfg, params, 0.1, "bf16")),
        "K3 mega_loss_pipeline": ("K3", lambda: mega.mega_loss_pipeline(g, w, cfg, params, 0.1, "bf16")),
        "K4 mega_loss_and_grad": ("K4", lambda: mega_bwd.mega_loss_and_grad(g, w, cfg, params, 0.1, "bf16")),
        "K5 ngp_loss_and_grad": ("K5", lambda: mega_ngp.ngp_loss_and_grad(g, w, ncfg, nparams, 0.1, "bf16")),
        "K5 ngp_loss_and_grad_plain": ("K5", lambda: mega_ngp.ngp_loss_and_grad_plain(g, w, ncfg, nparams, 0.1,
                                                                                      "bf16")),
        "K5 make_ngp_train_step": ("K5", lambda: (lambda st: st[0](st[1]))(
            make_ngp_train_step(g, w, ncfg, TrainConfig(), nparams, "bf16", backward="mega"))),
        "K6 fit_loss_and_grad": ("K6", lambda: kfit.fit_loss_and_grad(g, cfg, params, target, 0.1, w, "bf16")),
        "K7 ngp_fit_loss_and_grad": ("K7", lambda: kfit.ngp_fit_loss_and_grad(g, ncfg, nparams, target, 0.1, w,
                                                                              "bf16")),
    }


@pytest.mark.parametrize("case", ["K1 residuals_fused", "K1 residuals_fused_packed", "K2 generate_fields_fused",
                                  "K3 mega_loss_pipeline", "K4 mega_loss_and_grad", "K5 ngp_loss_and_grad",
                                  "K5 ngp_loss_and_grad_plain", "K5 make_ngp_train_step", "K6 fit_loss_and_grad",
                                  "K7 ngp_fit_loss_and_grad"])
def test_bf16_error_names_its_own_kernel(case):
    """precision="bf16" runs on the CPU through the wrappers of every kernel
    that has the tier (K2-K7: their plain bf16 versions); K1's f32 wrappers
    raise ValueError that names K1, and no other kernel, with its bf16-I/O
    entry points."""
    kernel, call = _bf16_calls()[case]
    if kernel != "K1":
        out = call()
        leaves = [x for x in (out if isinstance(out, tuple) else (out,)) if isinstance(x, torch.Tensor)]
        assert leaves and all(bool(torch.isfinite(x).all()) for x in leaves), case
        return
    with pytest.raises(ValueError, match="residuals_fused_packed_bf16") as info:
        call()
    msg = str(info.value)
    assert msg.startswith(f"{kernel}: ") and set(re.findall(r"\bK\d\b", msg)) == {kernel}, msg
    assert "residuals_fused_packed_mixed_out" in msg, msg


def test_wrappers_refuse_devices_without_a_kernel():
    g = GridSpec(nx=8, ny=4, nz=3)
    packed = torch.zeros((12,) + g.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        kres.residuals_fused_packed(g, packed)
    with pytest.raises(ValueError, match="different devices"):
        _build.uses_kernel(torch.zeros(2), torch.zeros(2, device="meta"))


def test_entry_builds_the_flagship_forward_on_the_given_device():
    import __graft_entry__
    from phys_autodiff_tpu_torch import entry as port_entry

    fn, (params,) = port_entry.entry(torch.device("cpu"))
    assert callable(fn)
    jax_fn, (jax_params,) = __graft_entry__.entry()
    for k in jax_params:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jax_params[k]))
    assert port_entry.GRID == GridSpec(nx=128, ny=64, nz=64, hx=0.05, hy=0.05, hz=0.05, dt=1e-3)


ENTRY_POINTS = {
    "models.grid_coords": models.grid_coords,
    "models.mlp.init_params": mlp.init_params,
    "models.mlp.params_from_jax": mlp.params_from_jax,
    "models.mlp.from_reference_layout": mlp.from_reference_layout,
    "models.ngp.init_ngp_params": ngp.init_ngp_params,
    "models.ngp.params_from_jax": ngp.params_from_jax,
    "models.hash_encoder.init_hash_params": hash_encoder.init_hash_params,
    "models.fourier.init_params": fourier.init_params,
    "models.encoders.init_params": encoders.init_params,
    "train.init_state": init_state,
    "train.fit": fit,
    "train.fit_scan": fit_scan,
    "train.fit_field.fit_field": fit_field.fit_field,
    "train.fit_field.make_fit_step": fit_field.make_fit_step,
    "train.fit_field.init_any": fit_field.init_any,
    "train.fit_field.target_from_arrays": fit_field.target_from_arrays,
    "models.modelio.load_model": modelio.load_model,
    "ops.obstacles.box_mask": obstacles.box_mask,
    "ops.obstacles.sphere_mask": obstacles.sphere_mask,
    "apps.euler.EulerSource.zeros": euler.EulerSource.zeros,
    "parallel.make_mesh": parallel.make_mesh,
    "parallel.make_mesh_2d": parallel.make_mesh_2d,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Every entry point that places tensors defaults to device="cuda";
    make_ngp_train_step's state follows its params0, which init_ngp_params
    puts on the card. Without a card, the call raises torch's own error."""
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


@pytest.mark.parametrize("command", ["train", "fit", "serve", "simulate"])
def test_the_clis_device_defaults_to_the_card(command):
    """The CLI's --device (the commands that place tensors) defaults to cuda."""
    sub = next(a for a in cli.build_parser()._actions if a.dest == "cmd")
    assert sub.choices[command].get_default("device") == "cuda"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_the_default_device_raises_without_a_card():
    with pytest.raises((AssertionError, RuntimeError)):
        mlp.init_params(MLPDims(H=4))
    with pytest.raises((AssertionError, RuntimeError)):
        ngp.init_ngp_params(ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, log2_table_size=6)))


def test_the_states_device_follows_the_params():
    ncfg = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, log2_table_size=6), hidden=8)
    _, state = make_ngp_train_step(GridSpec(nx=4, ny=4, nz=2), PhysWeights(), ncfg, TrainConfig(),
                                   ngp.init_ngp_params(ncfg, device="cpu"))
    assert {x.device.type for x in loop.tree.leaves(state.params)} == {"cpu"}
