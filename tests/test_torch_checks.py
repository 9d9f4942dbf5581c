"""utils/checks.py of the port against the JAX package's (checkify on the
CPU): each `checked` case on the same numpy input gives None where JAX
gives None and an error naming the same op otherwise; `guard_fields`
outside `checked` raises JAX's message; `assert_all_finite` on ok, NaN,
inf and empty trees (tests/test_utils.py:29-47); the kernel wrappers'
CPU path and their kernel route's report (kernels/_build.check) under
`checked`.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phys_autodiff_tpu.utils import checks as jchecks
from phys_autodiff_tpu_torch import GridSpec, MLPDims, MLPGridConfig, PhysWeights
from phys_autodiff_tpu_torch.kernels import _build, mega, mlp as kmlp
from phys_autodiff_tpu_torch.models import mlp
from phys_autodiff_tpu_torch.train import TrainConfig, init_state, make_train_step
from phys_autodiff_tpu_torch.utils import checks

torch.set_num_threads(1)

NAN, INF = float("nan"), float("inf")

# (name, the function in each package (jax.numpy / torch ops), the input)
CASES = {
    "guard of a*2 on [1, nan]": (lambda a: jchecks.guard_fields([a * 2]), lambda a: checks.guard_fields([a * 2]),
                                 [1.0, NAN]),
    "log(-1)": (jnp.log, torch.log, -1.0),
    "a / 0": (lambda a: a / 0.0, lambda a: a / 0.0, 1.0),
    "0 / 0": (lambda a: a / 0.0, lambda a: a / 0.0, 0.0),
    "a + 1 on inf": (lambda a: a + 1, lambda a: a + 1, INF),
    "a + 1 on [1, 2]": (lambda a: a + 1, lambda a: a + 1, [1.0, 2.0]),
    "sqrt(-1) * 2": (lambda a: jnp.sqrt(a) * 2, lambda a: torch.sqrt(a) * 2, -1.0),
    "exp(a) - exp(a) on inf": (lambda a: jnp.exp(a) - jnp.exp(a), lambda a: torch.exp(a) - torch.exp(a), INF),
    "a @ a.T on nan": (lambda a: a @ a.T, lambda a: a @ a.T, [[1.0, NAN], [2.0, 3.0]]),
    "transpose of nan": (lambda a: a.T, lambda a: a.T, [[1.0, NAN]]),
    "sum of [inf, -inf]": (jnp.sum, torch.sum, [INF, -INF]),
}


#: ATen ops and the JAX primitives of the same operation, where the names differ
_SAME_OP = {"mm": "dot_general", "sum": "reduce_sum"}


def _op(msg):
    """The op a message names, as JAX names it (or the message itself)."""
    if msg is None:
        return None
    m = re.match(r"nan generated by primitive: (\w+)\.", msg)
    return _SAME_OP.get(m.group(1), m.group(1)) if m else msg


@pytest.mark.parametrize("case", list(CASES))
def test_checked_gives_jaxs_answer(case):
    jfn, tfn, x = CASES[case]
    x = np.asarray(x, np.float32)
    jerr, jout = jchecks.checked(jfn)(jnp.asarray(x))
    terr, tout = checks.checked(tfn)(torch.tensor(x))
    assert _op(terr.get()) == _op(jerr.get()), (terr.get(), jerr.get())
    np.testing.assert_array_equal(np.asarray(tout[0] if isinstance(tout, list) else tout),
                                  np.asarray(jout[0] if isinstance(jout, list) else jout))
    if jerr.get() is None:
        terr.throw()  # no error
    else:
        with pytest.raises(checks.CheckError, match=re.escape(terr.get())):
            terr.throw()


def test_the_table_of_messages():
    """The messages themselves, as checkify words them."""
    t = torch.tensor
    assert checks.checked(lambda a: checks.guard_fields([a * 2]))(t([1.0, NAN]))[0].get() == \
        "nan generated by primitive: mul."
    assert checks.checked(torch.log)(t(-1.0))[0].get() == "nan generated by primitive: log."
    assert checks.checked(lambda a: a / 0.0)(t(1.0))[0].get() == "division by zero"
    assert checks.checked(lambda a: a + 1)(t(INF))[0].get() is None


def test_checked_log_as_in_test_utils():
    """tests/test_utils.py:35-47: log of -1 throws, of 2 passes."""
    err, out = checks.checked(torch.log)(torch.tensor(-1.0))
    with pytest.raises(Exception):
        err.throw()
    err, out = checks.checked(torch.log)(torch.tensor(2.0))
    err.throw()
    assert np.isfinite(float(out))


@pytest.mark.parametrize("leaf", [[1.0, NAN], [1.0, INF]])
def test_guard_fields_outside_checked_raises_jaxs_message(leaf):
    x = np.asarray(leaf, np.float32)
    with pytest.raises(Exception) as jinfo:
        jchecks.guard_fields([jnp.ones(2), jnp.asarray(x)], "u")
    with pytest.raises(checks.CheckError) as tinfo:
        checks.guard_fields([torch.ones(2), torch.tensor(x)], "u")
    assert str(tinfo.value) == "non-finite values in u[1]"
    assert str(jinfo.value).startswith(str(tinfo.value))
    fields = [torch.ones(2), torch.zeros(3)]
    assert checks.guard_fields(fields) is fields


def test_guard_fields_under_checked_records_its_leaves():
    """Under checked, guard_fields records each leaf's flag (JAX's checked
    enables float_checks only and drops a guard inside it: there the same
    call gives None, which the port does not copy)."""
    x = np.asarray([1.0, NAN], np.float32)
    assert jchecks.checked(lambda a: jchecks.guard_fields([a]))(jnp.asarray(x))[0].get() is None
    err, _ = checks.checked(lambda a: checks.guard_fields({"b": a, "a": torch.ones_like(a)}))(torch.tensor(x))
    assert err.get() == "non-finite values in fields[1]"  # the leaves in sorted-key order
    err, _ = checks.checked(lambda a: checks.guard_fields([a, a], "g"))(torch.tensor([1.0, INF]))
    assert err.get() == "non-finite values in g[0]"


@pytest.mark.parametrize("tree,ok", [
    ({"a": np.ones(4)}, True),
    ({"a": [1.0, NAN]}, False),
    ({"a": np.ones(2), "b": {"c": [INF, 1.0]}}, False),
    ({}, True),
    ([], True),
])
def test_assert_all_finite_as_jax(tree, ok):
    """tests/test_utils.py:29-32 and the inf and empty trees: the port raises
    where JAX raises, naming the same leaves."""
    jtree = jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.float32), tree, is_leaf=lambda v: isinstance(v, list))
    ttree = jax.tree_util.tree_map(lambda v: torch.tensor(np.asarray(v, np.float32)), tree,
                                   is_leaf=lambda v: isinstance(v, list))
    if ok:
        jchecks.assert_all_finite(jtree)
        checks.assert_all_finite(ttree)
        return
    with pytest.raises(FloatingPointError) as jinfo:
        jchecks.assert_all_finite(jtree, "params")
    with pytest.raises(FloatingPointError) as tinfo:
        checks.assert_all_finite(ttree, "params")
    assert str(tinfo.value) == str(jinfo.value)


def test_assert_all_finite_reads_the_host_once(monkeypatch):
    """One host read for the whole tree: the leaves' flags are stacked."""
    reads = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(1) or real(self, *a, **k))
    checks.assert_all_finite({f"w{i}": torch.ones(3) for i in range(6)})
    assert len(reads) == 1
    err, _ = checks.checked(lambda a: torch.log(a) + torch.exp(a) * a / 2)(torch.ones(5))
    reads.clear()
    assert err.get() is None and len(reads) == 1


def _flagship_small():
    g = GridSpec(nx=8, ny=6, nz=5, hx=0.5, hy=0.5, hz=0.5, dt=1e-3)
    cfg = MLPGridConfig(dims=MLPDims(H=16))
    return g, cfg, mlp.init_params(cfg.dims, seed=3, device="cpu")


@pytest.mark.parametrize("loss", ["mega", "staged"])
def test_a_kernel_wrappers_cpu_path_under_checked(loss):
    """K3's and K2 -> K1's wrappers take their plain versions on CPU tensors:
    under checked their ops are checked as any others. Clean params give
    None; a NaN planted in one W2 entry names the first op that computes
    with it."""
    g, cfg, params = _flagship_small()
    w = PhysWeights()
    fn = {"mega": lambda p: mega.mega_loss_pipeline(g, w, cfg, p, 0.25),
          "staged": lambda p: kmlp.fused_loss_pipeline(g, w, cfg, p, 0.25)}[loss]
    err, out = checks.checked(fn)(params)
    assert err.get() is None and all(bool(torch.isfinite(x)) for x in out)
    bad = {k: v.clone() for k, v in params.items()}
    bad["W2"][3, 1] = NAN
    err, out = checks.checked(fn)(bad)
    msg = err.get()
    assert msg is not None and msg.startswith("nan generated by primitive: "), msg
    assert _op(msg) not in ("K1", "K2", "K3")  # the CPU path launches no kernel
    with pytest.raises(checks.CheckError):
        err.throw()


def test_a_kernel_launch_is_one_primitive_named_after_the_kernel():
    """The kernel route reports its outputs through _build.check: under
    checked a NaN in them is flagged under the kernel's name, in launch
    order with the ops around it; outside checked nothing is recorded."""
    clean, dirty = torch.ones(4), torch.tensor([1.0, NAN])

    def launches(a):
        _build.check(0, "mega kernel (f32)", "K3", (clean,))
        b = a * 0.0
        _build.check(0, "backward mega kernel (f32)", "K4", (clean, None, dirty))
        return b

    err, _ = checks.checked(launches)(torch.ones(2))
    assert err.get() == "nan generated by primitive: K4."
    err, _ = checks.checked(launches)(torch.tensor([INF, 1.0]))
    assert err.get() == "nan generated by primitive: mul."  # inf * 0, before K4's launch
    _build.check(0, "probe kernel", "P1", (dirty,))  # outside checked: nothing to record
    assert checks._checker() is None


def test_a_launch_outside_checked_does_not_reach_the_checks(monkeypatch):
    """Outside `checked` a launch's report stops at one integer test
    (checks.active), which a checked call restores also when fn raises."""
    def boom(*a):
        raise AssertionError("record_kernel called outside checked")

    assert checks.active == 0
    with monkeypatch.context() as m:
        m.setattr(checks, "record_kernel", boom)
        _build.check(0, "mega kernel (f32)", "K3", (torch.tensor([NAN]),))
    with pytest.raises(ZeroDivisionError):
        checks.checked(lambda: 1 / 0)()
    assert checks.active == 0
    err, _ = checks.checked(lambda: (checks.active, _build.check(0, "probe kernel", "P1", (torch.tensor([NAN]),))))()
    assert err.get() == "nan generated by primitive: P1."
    assert checks.active == 0


def test_checked_sees_in_place_updates_and_a_whole_training_step():
    """An in-place `_foreach_*_` op returns nothing: the tensors it wrote
    are checked. A training step (autograd's backward and the optimizer's
    update included) runs under checked: clean, None; a NaN planted in b1
    names the first op that computes with it."""
    err, _ = checks.checked(lambda xs: torch._foreach_mul_(xs, 0.0))([torch.ones(2), torch.tensor([INF])])
    assert err.get() == "nan generated by primitive: _foreach_mul."
    g, cfg, _ = _flagship_small()
    tcfg = TrainConfig(steps=1, seed=3)
    for use_fused in (False, True):
        tc = dataclasses.replace(tcfg, use_fused=use_fused)
        step = make_train_step(g, PhysWeights(), cfg, tc)
        err, (state, loss) = checks.checked(step)(init_state(tc, cfg, device="cpu"))
        assert err.get() is None and state.step == 1 and bool(torch.isfinite(loss))
        state = init_state(tc, cfg, device="cpu")
        with torch.no_grad():
            state.params["b1"][0] = NAN
        err, _ = checks.checked(step)(state)
        assert err.get() is not None and err.get().startswith("nan generated by primitive: "), err.get()
