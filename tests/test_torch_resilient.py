"""train/resilient.py of the port: checkpoint-every-K training with failure
detection and auto-resume, the counterparts of tests/test_resilient.py's
9 tests (fault injection stands in for a crashed worker) at its sizes
(8x6x5, H=16), plus two hazards of the port's own: a step that fails after
opt.step() has moved the params in place, and sticky CUDA errors.

The port's steps update the params in place, so every uninterrupted oracle
here starts from a fresh state of the same seed, never from a state0 that
a run has used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.train import loop as jloop
from phys_autodiff_tpu.train import resilient as jresilient
from phys_autodiff_tpu.utils import config as jconfig
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.models import ngp
from phys_autodiff_tpu_torch.models.hash_encoder import HashEncodingConfig
from phys_autodiff_tpu_torch.train import checkpoint, loop, resilient
from phys_autodiff_tpu_torch.utils import tolerances as tol
from phys_autodiff_tpu_torch.utils import tree

torch.set_num_threads(1)

CPU = "cpu"


def _setup(**kw):
    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    w = PhysWeights()
    mcfg = MLPGridConfig(dims=MLPDims(H=16))
    cfg = loop.TrainConfig(**{"steps": 12, "learning_rate": 1e-3, "seed": 3, **kw})
    return g, w, mcfg, cfg


def _crashing_factory(g, w, mcfg, cfg, crash_at_call: int, after_update: bool = False):
    """The real step with one injected worker-crash-shaped failure at the
    crash_at_call-th invocation: before the step, or (after_update) after
    the step has updated the state in place."""
    calls = {"n": 0, "crashed": False, "factory": 0}

    def factory():
        calls["factory"] += 1
        real = loop.make_train_step(g, w, mcfg, cfg)

        def step(state):
            calls["n"] += 1
            crash = calls["n"] == crash_at_call and not calls["crashed"]
            if crash and not after_update:
                calls["crashed"] = True
                raise RuntimeError("worker process crashed or restarted")
            out = real(state)
            if crash:
                calls["crashed"] = True
                raise RuntimeError("connection reset by peer: worker lost after the update")
            return out

        return step

    return factory, calls


def _uninterrupted(g, w, mcfg, cfg, steps):
    state = loop.init_state(cfg, mcfg, device=CPU)
    step = loop.make_train_step(g, w, mcfg, cfg)
    for _ in range(steps):
        state, _ = step(state)
    return state


def _opt_leaves(state):
    return [v for _, st in sorted(state.opt.state_dict()["state"].items()) for _, v in sorted(st.items())]


def _assert_same_state(a, b):
    """Params, the Adam state, the step count and the generator: bitwise."""
    assert a.step == b.step
    for x, y in zip(tree.leaves(a.params), tree.leaves(b.params), strict=True):
        assert torch.equal(x, y)
    for x, y in zip(_opt_leaves(a), _opt_leaves(b), strict=True):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
    assert torch.equal(a.gen.get_state(), b.gen.get_state())


def _cat(p):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(p)])


def test_resilient_resumes_and_matches_uninterrupted_run(tmp_path):
    """A crash at the 7th step call resumes from the step-5 checkpoint: the
    final state is 12 uninterrupted steps' to the bit. Against the JAX
    package's fit_resilient from the same params with the same crash: the
    losses at the checkpoints and the params' displacement at the training
    class (utils/tolerances.py)."""
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg, device=CPU)
    p0 = ngp.params_to_numpy(state0.params)
    factory, calls = _crashing_factory(g, w, mcfg, cfg, crash_at_call=7)
    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=5, max_restarts=2)
    state, history, report = resilient.fit_resilient(factory, state0, cfg.steps, rcfg)
    assert report.failures == 1 and report.restores == 1
    assert report.steps_done == cfg.steps and state.step == cfg.steps
    assert calls["crashed"] and calls["n"] == 14  # 14 calls: 1-6 and 8-14 stepped, 7 raised
    assert [h[0] for h in history] == [5, 10, 12]
    _assert_same_state(state, _uninterrupted(g, w, mcfg, cfg, cfg.steps))

    # the JAX package's run from the same params, crashing at the same call
    jg = jconfig.GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    jmcfg = jconfig.MLPGridConfig(dims=jconfig.MLPDims(H=16))
    jcfg = jloop.TrainConfig(steps=12, learning_rate=1e-3, seed=3)
    jstate0 = jloop.init_state(jcfg, jmcfg)
    for k in p0:
        np.testing.assert_array_equal(p0[k], np.asarray(jstate0.params[k]))
    jcalls = {"n": 0}

    def jfactory():
        real = jloop.make_train_step(jg, jconfig.PhysWeights(), jmcfg, jcfg)

        def step(s):
            jcalls["n"] += 1
            if jcalls["n"] == 7:
                raise RuntimeError("TPU worker process crashed or restarted")
            return real(s)

        return step

    jrcfg = jresilient.ResilienceConfig(ckpt_path=str(tmp_path / "jck"), save_every=5, max_restarts=2)
    jstate, jhistory, jreport = jresilient.fit_resilient(jfactory, jstate0, 12, jrcfg)
    assert (jreport.failures, jreport.restores) == (report.failures, report.restores)
    assert [h[0] for h in jhistory] == [h[0] for h in history]
    for (_, lj), (_, lt) in zip(jhistory, history):
        assert abs(lt - lj) <= tol.TRAIN_LOSS_REL * abs(lj)
    d, d_ref = _cat(ngp.params_to_numpy(state.params)) - _cat(p0), _cat(jstate.params) - _cat(p0)
    assert np.linalg.norm(d - d_ref) <= tol.TRAIN_MOVED_REL * np.linalg.norm(d_ref)


def test_resilient_gives_up_after_max_restarts(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg, device=CPU)

    def factory():
        def step(state):
            raise RuntimeError("socket closed: worker unavailable")

        return step

    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=2)
    with pytest.raises(RuntimeError, match="giving up after 2 restarts"):
        resilient.fit_resilient(factory, state0, 8, rcfg)


def test_resilient_reraises_programming_errors(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg, device=CPU)

    def factory():
        def step(state):
            raise ValueError("shapes do not match")

        return step

    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=5)
    with pytest.raises(ValueError, match="shapes do not match"):
        resilient.fit_resilient(factory, state0, 8, rcfg)


def test_default_failure_predicate_classification():
    """JAX's cases (tests/test_resilient.py:100-119) give JAX's answers."""
    p, jp = resilient.default_failure_predicate, jresilient.default_failure_predicate

    class XlaRuntimeError(RuntimeError):  # stand-in for jaxlib's
        pass

    cases = {
        XlaRuntimeError("grpc UNAVAILABLE: socket closed"): True,
        RuntimeError("TPU worker process crashed or restarted"): True,
        RuntimeError("deadline exceeded talking to worker"): True,
        RuntimeError("anything"): False,
        XlaRuntimeError("INTERNAL: Mosaic lowering failed"): False,
        Exception("grpc UNAVAILABLE: socket closed"): False,
        ValueError("bad shape"): False,
        TypeError("not a pytree"): False,
    }
    for exc, want in cases.items():
        assert p(exc) == jp(exc) == want, exc


STICKY = [
    "backward mega kernel (f32): CUDA error 700 (an illegal memory access was encountered)",
    "CUDA error: an illegal memory access was encountered",
    "mlp kernel (bf16): CUDA error 702 (the launch timed out and was terminated)",
    "CUDA error: device-side assert triggered\nCompile with `TORCH_USE_CUDA_DSA` to enable device-side assertions.",
    "NGP fit kernel: CUDA error 714 (hardware stack error)",
    "CUDA error: an illegal instruction was encountered",
    "transport kernel: CUDA error 716 (misaligned address)",
    "CUDA error: operation not supported on global/shared address space",
    "mega kernel (f32): CUDA error 718 (invalid program counter)",
    "CUDA error: unspecified launch failure",
    "probe kernel: CUDA error 214 (uncorrectable ECC error encountered)",
    "residuals kernel: CUDA error 719 (worker restarted: connection reset)",  # the code decides
]


@pytest.mark.parametrize("msg", STICKY)
def test_sticky_cuda_errors_are_fatal(msg):
    """A sticky CUDA error leaves the process's context unusable: no retry
    in the process can heal it, so the predicate calls it fatal, whichever
    form it arrives in (kernels/_build.check's code, torch's message,
    torch.AcceleratorError)."""
    assert resilient.is_sticky_cuda_error(RuntimeError(msg))
    assert not resilient.default_failure_predicate(RuntimeError(msg))
    assert not resilient.default_failure_predicate(torch.AcceleratorError(msg))


def test_the_predicate_on_torchs_errors():
    """JAX's infrastructure messages and torch.distributed's (gloo's lost
    connection, an aborted NCCL communicator, a store timeout) are
    failures; out of memory, a plain RuntimeError, a non-sticky CUDA error
    and a failed check are not."""
    import torch.distributed as dist

    from phys_autodiff_tpu_torch.utils.checks import CheckError

    p = resilient.default_failure_predicate
    for exc in (RuntimeError("worker process crashed or restarted"),
                RuntimeError("grpc UNAVAILABLE: socket closed"),
                dist.DistNetworkError("Connection reset by peer"),
                dist.DistBackendError("[gloo] Connection closed by peer [127.0.0.1]:29500"),
                dist.DistBackendError("NCCL communicator was aborted on rank 0"),
                RuntimeError("Timed out waiting for the store key")):
        assert p(exc), exc
    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB (worker 0)"),
                RuntimeError("anything"),
                RuntimeError("mlp kernel (f32): CUDA error 1 (invalid argument)"),
                CheckError("nan generated by primitive: K3."),
                FloatingPointError("non-finite values in params (leaves [2])")):
        assert not p(exc), exc


def test_resilient_checkpoint_cadence_and_history(tmp_path):
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg, device=CPU)

    def factory():
        return loop.make_train_step(g, w, mcfg, cfg)

    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=5)
    state, history, report = resilient.fit_resilient(factory, state0, 12, rcfg)
    # initial + after bursts of 5, 5, 2
    assert report.checkpoints == 4 and report.failures == 0
    assert [h[0] for h in history] == [5, 10, 12]
    assert all(np.isfinite(h[1]) for h in history)
    # the on-disk checkpoint restores to the final state; its manifest counts the steps
    restored = checkpoint.restore_npz(rcfg.ckpt_path, loop.init_state(cfg, mcfg, device=CPU))
    _assert_same_state(restored, state)
    assert checkpoint.read_manifest(rcfg.ckpt_path)["extra"] == {"fit_done": 12}


def test_resilient_resumes_from_existing_checkpoint(tmp_path):
    """resume="auto": a process-level death resumes by re-running the same
    command; the existing checkpoint is loaded, not clobbered."""
    g, w, mcfg, cfg = _setup()

    def factory():
        return loop.make_train_step(g, w, mcfg, cfg)

    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=4)
    # "process 1" runs 8 steps and exits
    s1, _, _ = resilient.fit_resilient(factory, loop.init_state(cfg, mcfg, device=CPU), 8, rcfg)
    assert s1.step == 8
    # "process 2" re-runs the same command asking for 12 in all: it continues from step 8
    s2, hist2, rep2 = resilient.fit_resilient(factory, loop.init_state(cfg, mcfg, device=CPU), 12, rcfg)
    assert s2.step == 12 and rep2.restores == 1
    assert [h[0] for h in hist2] == [12]
    _assert_same_state(s2, _uninterrupted(g, w, mcfg, cfg, 12))
    # resume="restart" really does start over
    s3, _, rep3 = resilient.fit_resilient(factory, loop.init_state(cfg, mcfg, device=CPU), 4, rcfg,
                                          resume="restart")
    assert s3.step == 4 and rep3.restores == 0
    _assert_same_state(s3, _uninterrupted(g, w, mcfg, cfg, 4))


def test_resilient_failure_during_recovery_consumes_budget(tmp_path):
    """A worker that is still dying when the recovery rebuilds the step
    spends restarts, not the run."""
    g, w, mcfg, cfg = _setup()
    state0 = loop.init_state(cfg, mcfg, device=CPU)
    calls = {"factory": 0, "step": 0}

    def factory():
        calls["factory"] += 1
        if calls["factory"] == 2:
            # the FIRST rebuild after the crash fails too; the second succeeds
            raise RuntimeError("worker unavailable: socket closed")
        real = loop.make_train_step(g, w, mcfg, cfg)

        def step(state):
            calls["step"] += 1
            if calls["step"] == 3:
                raise RuntimeError("worker process crashed")
            return real(state)

        return step

    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=2, max_restarts=3)
    state, _, report = resilient.fit_resilient(factory, state0, 6, rcfg)
    assert state.step == 6
    assert report.failures == 2  # the step crash + the failed rebuild
    assert calls["factory"] == 3  # initial + failed rebuild + good rebuild
    _assert_same_state(state, _uninterrupted(g, w, mcfg, cfg, 6))


def test_a_failure_after_the_update_resumes_bitwise(tmp_path):
    """The port's hazard: a step updates the params, the Adam state and the
    generator in place, then fails (the 7th call, after step 6's update).
    The live state and state0 itself are then half-way into a burst;
    recovery must come from the checkpoint file, and the run still ends
    bitwise on 12 uninterrupted steps. t is sampled (uniform), so the
    generator state matters too."""
    g, w, mcfg, cfg = _setup(t_sampling="uniform")
    state0 = loop.init_state(cfg, mcfg, device=CPU)
    fresh = loop.init_state(cfg, mcfg, device=CPU)
    factory, calls = _crashing_factory(g, w, mcfg, cfg, crash_at_call=7, after_update=True)
    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=5, max_restarts=1)
    state, history, report = resilient.fit_resilient(factory, state0, 12, rcfg)
    assert report.failures == 1 and calls["crashed"] and calls["n"] == 14
    # state0's tensors were moved by the run (in place), so a resume from
    # them would have been wrong
    assert not torch.equal(state0.params["W1"], fresh.params["W1"])
    assert state.step == 12 and [h[0] for h in history] == [5, 10, 12]
    _assert_same_state(state, _uninterrupted(g, w, mcfg, cfg, 12))


def test_resilient_serves_the_ngp_step(tmp_path):
    """fit_resilient over make_ngp_train_step (the encoded-field family,
    backward="xla" on the CPU as in the JAX test) with an injected crash:
    the checkpoint's meta carries the encoding schedule and validates on
    resume; the run ends bitwise on 6 uninterrupted steps."""
    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    enc = HashEncodingConfig(num_levels=2, base_resolution=4, max_resolution=6, log2_table_size=6)
    ncfg = ngp.NGPFieldConfig(encoding=enc, hidden=8)
    params0 = ngp.init_ngp_params(ncfg, seed=0, device=CPU)
    cfg = loop.TrainConfig(steps=6, learning_rate=1e-3, seed=1)
    calls = {"n": 0, "crashed": False}

    def factory():
        real, _ = loop.make_ngp_train_step(g, PhysWeights(), ncfg, cfg, params0, backward="xla")

        def step(state):
            calls["n"] += 1
            if calls["n"] == 4 and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("worker process crashed")
            return real(state)

        return step

    _, state0 = loop.make_ngp_train_step(g, PhysWeights(), ncfg, cfg, params0, backward="xla")
    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ngp"), save_every=2, max_restarts=2,
                                      meta=ngp.checkpoint_meta(ncfg))
    state, hist, report = resilient.fit_resilient(factory, state0, 6, rcfg)
    assert report.failures == 1 and report.steps_done == 6 and state.step == 6
    assert all(np.isfinite(h[1]) for h in hist)
    assert checkpoint.read_manifest(rcfg.ckpt_path)["meta"] == ngp.checkpoint_meta(ncfg)
    step, ref = loop.make_ngp_train_step(g, PhysWeights(), ncfg, cfg, params0, backward="xla")
    for _ in range(6):
        ref, _ = step(ref)
    _assert_same_state(state, ref)
    # another encoding schedule is refused on resume
    other = ngp.NGPFieldConfig(encoding=HashEncodingConfig(num_levels=2, base_resolution=4, max_resolution=8,
                                                           log2_table_size=6), hidden=8)
    bad = resilient.ResilienceConfig(ckpt_path=rcfg.ckpt_path, meta=ngp.checkpoint_meta(other))
    with pytest.raises(ValueError, match="meta does not match"):
        resilient.fit_resilient(factory, state0, 8, bad)


def test_resilient_stepless_pytree_tracks_progress(tmp_path):
    """A plain dict state (no .step) keeps its progress count across
    failures and process-level resumes: the completed-step counter rides
    the checkpoint manifest, not the state."""
    # deterministic "optimizer": x <- x + 1, so the step count IS the value
    calls = {"n": 0, "crashed": False}

    def factory():
        def step(state):
            calls["n"] += 1
            if calls["n"] == 9 and not calls["crashed"]:
                calls["crashed"] = True
                raise RuntimeError("worker process crashed or restarted")
            return {"x": state["x"] + 1.0}, torch.tensor(0.0)

        return step

    state0 = {"x": torch.zeros(())}
    rcfg = resilient.ResilienceConfig(ckpt_path=str(tmp_path / "ck"), save_every=4, max_restarts=2)
    # crash at call 9 = the first step after the step-8 checkpoint; resume
    # must redo only steps 9..10, landing on exactly x == 10
    state, history, report = resilient.fit_resilient(factory, state0, 10, rcfg)
    assert report.failures == 1 and report.restores == 1
    assert report.steps_done == 10 and float(state["x"]) == 10.0
    assert [h[0] for h in history] == [4, 8, 10]
    # process-level resume: asking for 14 in all continues from 10, not 0
    s2, hist2, rep2 = resilient.fit_resilient(factory, state0, 14, rcfg)
    assert float(s2["x"]) == 14.0
    assert rep2.steps_done == 14 and rep2.restores == 1
    assert [h[0] for h in hist2] == [14]
    # JAX's run of the same gives the same history
    jcalls = {"n": 0}

    def jfactory():
        def step(s):
            jcalls["n"] += 1
            if jcalls["n"] == 9:
                raise RuntimeError("TPU worker process crashed or restarted")
            return {"x": s["x"] + 1.0}, jnp.float32(0.0)

        return step

    jrcfg = jresilient.ResilienceConfig(ckpt_path=str(tmp_path / "jck"), save_every=4, max_restarts=2)
    _, jhist, _ = jresilient.fit_resilient(jfactory, {"x": jnp.zeros(())}, 10, jrcfg)
    _, jhist2, _ = jresilient.fit_resilient(jfactory, {"x": jnp.zeros(())}, 14, jrcfg)
    assert [h[0] for h in jhist] == [4, 8, 10] and [h[0] for h in jhist2] == [14]
