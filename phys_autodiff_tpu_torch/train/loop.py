"""The closed training loop: the MLP weights optimized against the physics
loss (port of phys_autodiff_tpu/train/loop.py).

The JAX module is one jax.value_and_grad plus an optax update, jitted. Here
PyTorch runs eagerly: autograd gives the gradients (or K4 gives them in one
kernel call, on the fused step) and torch.optim applies them. What the port
keeps from optax, exactly:

  * The optax schedules count updates from 0, so with warmup the first
    update uses lr = 0. `make_schedule` is a plain function of the update
    count, and the step writes its value into the optimizer's param_groups
    before optimizer.step() (not LambdaLR, whose factor applies from the
    step after).
  * optax.clip_by_global_norm scales by max_norm / norm with no epsilon
    (torch.nn.utils.clip_grad_norm_ adds 1e-6), so the clip is written out.
  * optax.adam / adamw (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt) are
    torch.optim.Adam / AdamW with the same constants: the same update, in
    another rounding order. optax.sgd is torch.optim.SGD without momentum.

A step updates the params and the optimizer state in place (torch.optim's
contract; it saves a copy of the model and the optimizer state) and returns
the state with its counter advanced. The JAX PRNG key becomes a CPU
torch.Generator, used to sample t when t_sampling="uniform".

Params are a dict, nested for the encoded-field model ({"tables": {...},
W1, b1, W2, b2}); the optimizer, the clip and the update walk its leaves in
jax.tree_util's order (utils/tree.py). make_ngp_train_step trains that
model with one call of the NGP backward mega-kernel K5 a step;
make_generic_train_step trains any field generator by autograd.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from phys_autodiff_tpu_torch.utils.config import GridSpec, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build
from phys_autodiff_tpu_torch.kernels.mega_bwd import mega_fits, mega_loss_and_grad, mega_supported
from phys_autodiff_tpu_torch.kernels.mega_ngp import (
    MAX_LF, SLICES_MAX_H, SLICES_MAX_LF, ngp_fits, ngp_loss_and_grad, ngp_supported, slices_fits,
)
from phys_autodiff_tpu_torch.kernels.mlp import _PARAM_KEYS
from phys_autodiff_tpu_torch.kernels.residuals import loss_forward_fused_packed, pack_fields
from phys_autodiff_tpu_torch.models import encoders
from phys_autodiff_tpu_torch.models import fields as fields_mod
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.models import ngp as ngp_mod
from phys_autodiff_tpu_torch.ops import loss as ops_loss
from phys_autodiff_tpu_torch.ops.stencil import FieldSnapshots
from phys_autodiff_tpu_torch.utils import tree
from phys_autodiff_tpu_torch.utils.timing import annotate


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "adamw" | "sgd"
    weight_decay: float = 0.0  # decoupled weight decay (optimizer="adamw")
    grad_clip: float = 0.0  # global-norm gradient clip; 0 disables
    lr_schedule: str = "constant"  # "constant" | "cosine" (warmup ->
    # cosine decay to lr_final_scale * learning_rate over cfg.steps)
    warmup_steps: int = 0  # linear warmup from 0 (schedules only)
    lr_final_scale: float = 0.0  # cosine floor as a fraction of peak lr
    t: float = 0.25  # snapshot time ("fixed") or sampling base
    t_sampling: str = "fixed"  # "fixed" | "uniform" (t ~ U(0,1) per step)
    seed: int = 0
    log_every: int = 10
    use_fused: bool = False  # fused step: the backward mega-kernel K4
    # (mega_loss_and_grad: loss and every gradient in one call) when its
    # gates hold, else autograd of the fused loss (train/slab_grad.py:
    # K3 or K2 -> K1 forward, the slab-recompute gradient backward)
    precision: str = "f32"  # fused-step compute precision: kernels/_build.TIERS
    # ("bf16": K3 / K4 with layer 2 on the tensor cores)
    remat: bool = False  # recompute field generation in the backward
    # (torch.utils.checkpoint: drops the [N, H] hidden activations)
    matmul_precision: str | None = None  # None | "bfloat16" |
    # "tensorfloat32" | "float32": torch.set_float32_matmul_precision
    # ("medium" / "high" / "highest") for the step; the CUDA kernels are
    # FMA code and do not read it


class TrainState(NamedTuple):
    params: dict  # a (nested) dict of leaf tensors, updated in place
    opt: torch.optim.Optimizer
    step: int  # updates applied so far (optax's schedule count)
    gen: torch.Generator  # samples t (t_sampling="uniform")


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr(count) of the count-th update (count from 0), as optax's
    constant / linear_schedule / warmup_cosine_decay_schedule give it."""
    lr, warm = cfg.learning_rate, cfg.warmup_steps

    def linear(count):  # optax.linear_schedule(0, lr, warm)
        return lr * min(max(count, 0), warm) / warm

    if cfg.lr_schedule == "constant":
        if warm > 0:
            return linear
        return lambda count: lr
    if cfg.lr_schedule == "cosine":
        decay = max(cfg.steps, warm + 1) - warm
        end = cfg.lr_final_scale * lr
        alpha = 0.0 if lr == 0.0 else end / lr

        def cosine(count):
            if warm > 0 and count < warm:
                return linear(count)
            c = min(count - warm, decay)
            return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay)) + alpha)

        return cosine
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def make_optimizer(cfg: TrainConfig, params: dict) -> torch.optim.Optimizer:
    """The torch.optim counterpart of the optax chain for cfg (the clip and
    the schedule are applied by the step), over every leaf of `params` in
    tree.leaves order."""
    ps = tree.leaves(params)
    lr = make_schedule(cfg)(0)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(ps, lr=lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def init_state(
    cfg: TrainConfig, mcfg: MLPGridConfig, seed: int | None = None, device="cuda"
) -> TrainState:
    """Seeded params (bitwise those of the JAX package's init_params) on
    `device`, a fresh optimizer, and a generator seeded the same way."""
    seed = cfg.seed if seed is None else seed
    return state_from_params(cfg, mlp.init_params(mcfg.dims, seed=seed, device=device), seed)


def state_from_params(cfg: TrainConfig, params: dict, seed: int | None = None) -> TrainState:
    """A step-0 TrainState around given params (a nested dict, copied as
    leaf tensors)."""
    params = tree.map_tree(lambda x: x.detach().clone().requires_grad_(), params)
    gen = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    return TrainState(params=params, opt=make_optimizer(cfg, params), step=0, gen=gen)


def loss_fn(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    params: mlp.Params,
    t,
    use_fused: bool = False,
    remat: bool = False,
    precision: str = "f32",
):
    """Scalar physics loss of the MLP-generated fields at time t.

    use_fused=True: the forward is K3, the backward K4, or past their gates
    K2 -> K1 and the slab-recompute gradient
    (train/slab_grad.make_fused_loss); nothing grid-sized is kept."""
    if use_fused:
        from phys_autodiff_tpu_torch.train.slab_grad import make_fused_loss

        return make_fused_loss(g, w, mcfg, precision)(params, t)

    def gen(*weights):
        return tuple(fields_mod.generate_fields(g, mcfg, dict(zip(_PARAM_KEYS, weights)), t, g.dt))

    weights = [params[k] for k in _PARAM_KEYS]
    fs = checkpoint(gen, *weights, use_reentrant=False) if remat else gen(*weights)
    return ops_loss.total_loss(g, w, FieldSnapshots(*fs))


def _clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    """optax.clip_by_global_norm: g * (max_norm / norm) when norm >= max_norm
    (no epsilon), norm over the leaves in jax's order (tree.leaves)."""
    norm = torch.sqrt(sum(torch.sum(v * v) for v in tree.leaves(grads)))
    keep = norm < max_norm
    return tree.map_tree(lambda v: torch.where(keep, v, (v / norm) * max_norm), grads)


def _apply_grads(cfg: TrainConfig, schedule, state: TrainState, grads: dict) -> TrainState:
    """One optimizer update of state.params from `grads` (a tree shaped
    like the params): the optional clip, the scheduled lr, the step."""
    if cfg.grad_clip > 0.0:
        grads = _clip_by_global_norm(grads, cfg.grad_clip)
    lr = schedule(state.step)
    for group in state.opt.param_groups:
        group["lr"] = lr
    leaves = tree.leaves(state.params)
    for p, gr in zip(leaves, tree.leaves(grads)):
        p.grad = gr
    state.opt.step()
    for p in leaves:
        p.grad = None
    return state._replace(step=state.step + 1)


def _sample_t(cfg: TrainConfig, gen: torch.Generator) -> float:
    if cfg.t_sampling == "uniform":
        return float(torch.rand((), generator=gen))
    return cfg.t


_MATMUL_PRECISION = {"bfloat16": "medium", "tensorfloat32": "high", "float32": "highest"}


@contextlib.contextmanager
def _matmul_precision(name: str | None):
    if name is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_MATMUL_PRECISION[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _make_step_fn(g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, cfg: TrainConfig):
    schedule = make_schedule(cfg)
    # The fused step: ONE call of the backward mega-kernel gives the loss
    # and every gradient (kernels/mega_bwd.py); otherwise autograd of
    # loss_fn, whose fused arm still runs K3 forward and K4 backward.
    tier = _build.check_precision(cfg.precision, "K4") if cfg.use_fused else "f32"
    use_mega_bwd = cfg.use_fused and mega_supported(g) and mega_fits(g, mcfg.dims.H, tier)

    def step(state: TrainState):
        with annotate("pat.step", state.step), _matmul_precision(cfg.matmul_precision):
            t = _sample_t(cfg, state.gen)
            if use_mega_bwd:
                loss, (grads, _) = mega_loss_and_grad(g, w, mcfg, state.params, t, cfg.precision)
            else:
                loss = loss_fn(g, w, mcfg, state.params, t, cfg.use_fused, cfg.remat, cfg.precision)
                gl = torch.autograd.grad(loss, [state.params[k] for k in _PARAM_KEYS])
                grads, loss = dict(zip(_PARAM_KEYS, gl)), loss.detach()
            state = _apply_grads(cfg, schedule, state, grads)
        return state, loss

    return step


def make_train_step(
    g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, cfg: TrainConfig
) -> Callable[[TrainState], tuple[TrainState, torch.Tensor]]:
    """Returns step(state) -> (state', loss); the loss is that of the
    params before the update, as in the JAX step."""
    return _make_step_fn(g, w, mcfg, cfg)


def make_train_epoch(g: GridSpec, w: PhysWeights, mcfg: MLPGridConfig, cfg: TrainConfig, steps_per_call: int):
    """epoch(state) -> (state', losses [steps_per_call]): `steps_per_call`
    steps in a plain loop, with the per-step loss trace (the JAX version is
    one lax.scan program; a CUDA graph of the step is later work)."""
    step = _make_step_fn(g, w, mcfg, cfg)

    def epoch(state: TrainState):
        losses = []
        for _ in range(steps_per_call):
            state, loss = step(state)
            losses.append(loss)
        return state, torch.stack(losses)

    return epoch


def fit(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    cfg: TrainConfig,
    state: TrainState | None = None,
    callback: Callable[[int, float], None] | None = None,
    device="cuda",
):
    """Run the loop; returns (final_state, history, elapsed_seconds), history
    a list of (step, loss) pairs every cfg.log_every steps and at the last.
    `device` places a fresh state (when `state` is None)."""
    if state is None:
        state = init_state(cfg, mcfg, device=device)
    step = make_train_step(g, w, mcfg, cfg)
    history = []
    t0 = time.perf_counter()
    for i in range(cfg.steps):
        state, loss = step(state)
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            loss_f = float(loss)
            history.append((state.step, loss_f))
            if callback:
                callback(state.step, loss_f)
    return state, history, time.perf_counter() - t0


def fit_scan(
    g: GridSpec,
    w: PhysWeights,
    mcfg: MLPGridConfig,
    cfg: TrainConfig,
    state: TrainState | None = None,
    callback: Callable[[int, float], None] | None = None,
    steps_per_call: int | None = None,
    device="cuda",
):
    """Like fit(), in chunks of `steps_per_call` steps (default log_every)
    through make_train_epoch; history holds one (step, loss) pair per chunk,
    the LAST loss of each chunk."""
    if state is None:
        state = init_state(cfg, mcfg, device=device)
    chunk = steps_per_call or max(1, cfg.log_every)
    history = []
    t0 = time.perf_counter()
    done = 0
    while done < cfg.steps:
        this = min(chunk, cfg.steps - done)
        state, losses = make_train_epoch(g, w, mcfg, cfg, this)(state)
        done += this
        loss_f = float(losses[-1])
        history.append((state.step, loss_f))
        if callback:
            callback(state.step, loss_f)
    return state, history, time.perf_counter() - t0


def resolve_ngp_backward(backward: str, g: GridSpec, ncfg, precision: str = "f32", on_card: bool = False) -> str:
    """make_ngp_train_step's engine: "mega" (K5) or "xla". "auto" takes
    "mega" on the card only where K5 takes the grid and the head
    (ngp_supported(g), out = 4 and ngp_fits(LF, H, tier)), else "xla",
    which runs the same tier's head (never a bf16 request in float32); for
    CPU params it takes "mega" (K5's plain version) wherever
    ngp_supported(g) holds. An explicit "mega" on the card outside the
    gates raises ValueError naming them."""
    tier = ngp_mod.check_precision(precision, "K5")
    if backward == "xla":
        return "xla"
    if backward not in ("mega", "auto"):
        raise ValueError(f"unknown backward {backward!r}")
    if encoders.time_aware(ncfg.encoding):
        return _resolve_slices(backward, g, ncfg, tier, on_card)
    if not on_card:
        return "mega" if backward == "mega" or ngp_supported(g) else "xla"
    lf, h = ncfg.encoding.out_dim, ncfg.hidden
    if ngp_supported(g) and ncfg.out == 4 and ngp_fits(lf, h, tier):
        return "mega"
    if backward == "auto":
        return "xla"
    top = _build.gate_top(lambda x: ngp_fits(lf, x, tier)) if 1 <= lf <= MAX_LF else 0
    raise ValueError(
        f"backward='mega', precision={precision!r}: K5 ({tier}) takes central or upwind grids, out = 4 and "
        f"LF <= {MAX_LF}, H <= {top} at LF={lf} (got scheme {g.scheme!r}, out={ncfg.out}, H={h}); "
        f"backward='auto' takes xla there"
    )


def _resolve_slices(backward: str, g: GridSpec, ncfg, tier: str, on_card: bool) -> str:
    """resolve_ngp_backward of a time-aware encoding (K5 on per-slice
    encodings, f32 alone, LF <= 128, H <= 64): the same rules, but a tier
    other than f32 raises, naming the family, whatever the backward."""
    name = encoders.family_of(ncfg.encoding).name
    if tier != "f32":
        raise ValueError(f"the {name!r} encoding depends on t: K5 runs it in the f32 tier alone, not {tier!r}")
    if not on_card:
        return "mega" if backward == "mega" or ngp_supported(g) else "xla"
    lf, h = ncfg.encoding.out_dim, ncfg.hidden
    if ngp_supported(g) and ncfg.out == 4 and slices_fits(lf, h):
        return "mega"
    if backward == "auto":
        return "xla"
    raise ValueError(
        f"backward='mega': K5 on the {name!r} encoding's per-slice encodings takes central or upwind grids, out = 4, "
        f"LF <= {SLICES_MAX_LF} and H <= {SLICES_MAX_H} (got scheme {g.scheme!r}, out={ncfg.out}, LF={lf}, H={h})"
    )


def make_ngp_train_step(
    g: GridSpec,
    w: PhysWeights,
    ncfg,
    cfg: TrainConfig,
    params0: dict,
    precision: str = "f32",
    backward: str = "auto",
):
    """Training step of the encoded-field (NGP) model; returns (step,
    state0), step(state) -> (state', loss).

    backward="mega": ONE call of the NGP backward mega-kernel a step
    (kernels/mega_ngp.ngp_loss_and_grad: loss, head gradients and the
    encoding cotangent; the encoder's pull-back by autograd). "xla": autograd
    through ngp.generate_fields and the physics loss (make_generic_train_step;
    the JAX package's name for that arm), with the tier's head. "auto":
    resolve_ngp_backward. State and device follow params0."""
    on_card = tree.leaves(params0)[0].device.type == "cuda"
    backward = resolve_ngp_backward(backward, g, ncfg, precision, on_card)
    if backward == "xla":
        return make_generic_train_step(
            g,
            w,
            lambda p, t: ngp_mod.generate_fields(g, ncfg, p, t, g.dt, precision),
            cfg,
            params0,
            generate_packed_fn=lambda p, t: ngp_mod.generate_fields_packed(g, ncfg, p, t, g.dt, precision),
        )
    schedule = make_schedule(cfg)

    def step(state: TrainState):
        with annotate("pat.step", state.step):
            t = _sample_t(cfg, state.gen)
            loss, (grads, _) = ngp_loss_and_grad(g, w, ncfg, state.params, t, precision)
            return _apply_grads(cfg, schedule, state, grads), loss

    return step, state_from_params(cfg, params0)


def make_generic_train_step(
    g: GridSpec,
    w: PhysWeights,
    generate_fn,
    cfg: TrainConfig,
    params0: dict,
    physics_loss: str = "auto",
    generate_packed_fn=None,
):
    """Training step for any differentiable field generator
    `generate_fn(params, t) -> FieldSnapshots`, by autograd; returns
    (step, state0).

    physics_loss: "staged" runs the plain residual chain (ops.total_loss);
    "fused" the fused loss kernel K1 (loss_forward_fused_packed, whose
    autograd.Function's backward is the staged adjoint), fed by
    `generate_packed_fn(params, t) -> [12, nz, ny, nx]` when given (no
    pack copy), else by pack_fields(generate_fn(...)). "auto" is "fused"
    for params on the card and "staged" for params on the CPU."""
    schedule = make_schedule(cfg)
    state0 = state_from_params(cfg, params0)
    if physics_loss == "auto":
        on_card = tree.leaves(state0.params)[0].device.type == "cuda"
        physics_loss = "fused" if on_card else "staged"
    if physics_loss == "fused":
        packed_of = generate_packed_fn or (lambda p, t: pack_fields(generate_fn(p, t)))

        def total_loss_of(p, t):
            ls, lu = loss_forward_fused_packed(g, w, packed_of(p, t))
            return ls + lu

    elif physics_loss == "staged":

        def total_loss_of(p, t):
            return ops_loss.total_loss(g, w, generate_fn(p, t))

    else:
        raise ValueError(f"unknown physics_loss {physics_loss!r}")

    def step(state: TrainState):
        t = _sample_t(cfg, state.gen)
        loss = total_loss_of(state.params, t)
        leaves = tree.leaves(state.params)
        gl = torch.autograd.grad(loss, leaves, allow_unused=True)
        gl = [torch.zeros_like(p) if gr is None else gr for gr, p in zip(gl, leaves)]
        return _apply_grads(cfg, schedule, state, tree.unflatten(state.params, gl)), loss.detach()

    return step, state0
