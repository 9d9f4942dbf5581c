"""Numerical-health guards (port of phys_autodiff_tpu/utils/checks.py).

  * `assert_all_finite(tree)`: a host-side check of any tree of tensors,
    one host read for the whole tree.
  * `checked(fn)`: fn wrapped so that a call returns (err, out); err
    records the first op whose output holds a NaN, and any division by
    zero, without a host read until err.get() or err.throw().
  * `guard_fields(fields)`: under `checked`, records whether each leaf is
    finite; outside it, checks at once and raises.

torch has no checkify, so `checked` runs fn under a TorchDispatchMode that
sees every ATen op. After each op it queues, on the op's device, a flag:
"the output holds a NaN" and, for a division, "the divisor holds a zero".
The flags stay on the device; err.get() stacks them and reads them once.
How it differs from jax.experimental.checkify(errors=float_checks):

  * checkify checks a fixed list of arithmetic primitives. Here every op
    that computes values is checked; the ops that only create, move, copy,
    select or convert values (views, `clone`, `cat`, `where`, `index`,
    `_to_copy`, ...; `_CARRY`) are not, as checkify does not check their
    primitives. An op is named by its ATen name without the in-place
    underscore ("mul" for `mul_`), as checkify names the primitive.
  * The port's CUDA kernels launch through ctypes and never pass the
    dispatcher. Each kernel wrapper reports its launch to
    `kernels/_build.check`, which checks the kernel's outputs as one
    primitive named after the kernel ("K3"); K8's wrapper reports its
    channel launches' output once.
  * The check runs eagerly, op by op, on the ops that run: a Python branch
    that reads a tensor's value already syncs the host, and nothing is
    traced. Each checked op adds two small device launches (isnan, any).
  * An inf is not flagged, as in checkify: only NaNs and a zero divisor.
  * A `guard_fields` inside `checked` is recorded. The JAX `checked`
    enables float_checks only, so it drops the guard's user check: there
    checked(lambda a: guard_fields([a])) on a NaN gives None.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

#: ATen ops that only create, move, copy, select or convert values: a NaN
#: in their output came from their input (or from uninitialised memory,
#: for `empty`), so they are not checked.
_CARRY = frozenset("""
    empty empty_like empty_strided new_empty new_empty_strided zeros zeros_like ones ones_like full full_like
    new_zeros new_ones new_full scalar_tensor arange lift_fresh lift_fresh_copy detach alias view _unsafe_view
    reshape _reshape_alias view_as t transpose permute expand squeeze unsqueeze flatten unflatten select slice
    narrow as_strided unbind split split_with_sizes chunk movedim diagonal clone copy _to_copy _copy_from
    _copy_from_and_resize contiguous cat stack flip roll index index_select gather take masked_select where
    masked_fill index_put index_copy scatter select_scatter slice_scatter as_strided_scatter fill zero repeat
    resize set view_as_real view_as_complex real imag conj _conj resolve_conj resolve_neg _neg_view
""".split())

#: Divisions (checkify checks lax.div, which 1 / x and // also lower to):
#: the divisor's position among the op's arguments.
_DIVISOR = {"div": 1, "_foreach_div": 1, "reciprocal": 0, "floor_divide": 1}


#: How many `checked` calls are running in this process. The kernel
#: wrappers call record_kernel only while it is nonzero, so a launch outside
#: `checked` pays one integer test.
active = 0


class CheckError(ValueError):
    """A failed check (the counterpart of checkify's JaxRuntimeError, also
    a ValueError)."""


class Error:
    """What `checked` recorded: the flags on the device and their messages."""

    def __init__(self, flags: list, messages: list[str]):
        self._flags, self._messages = flags, messages

    def get(self) -> str | None:
        """The first recorded error's message, or None; one host read (a
        device)."""
        hit = _read(self._flags)
        return next((m for m, h in zip(self._messages, hit) if h), None)

    def throw(self) -> None:
        """Raise CheckError with the first recorded error, if any."""
        msg = self.get()
        if msg is not None:
            raise CheckError(msg)


def _name(func) -> str:
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


def _tensors(x) -> list[torch.Tensor]:
    """The tensors in x (a tensor, or nested lists / tuples; None and
    numbers skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _written(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an op writes in place (a `_foreach_*_` op returns none)."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is not None and arg.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(arg.name))
    return out


def _any_nan(tensors) -> torch.Tensor | None:
    flags = [torch.isnan(t).any() for t in tensors if t.is_floating_point() or t.is_complex()]
    if not flags:
        return None
    return flags[0] if len(flags) == 1 else torch.stack([f.to(flags[0].device) for f in flags]).any()


class _Checker(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flags: list[torch.Tensor] = []
        self.messages: list[str] = []
        self.quiet = False  # computing flags of its own: not checked

    def record(self, flag: torch.Tensor | None, message: str) -> None:
        if flag is not None:
            self.flags.append(flag.reshape(()))
            self.messages.append(message)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        name = _name(func)
        if name in _DIVISOR:
            divisor = args[_DIVISOR[name]] if len(args) > _DIVISOR[name] else kwargs.get("other")
            zero = [(d == 0).any() for d in _tensors(divisor)]
            if isinstance(divisor, (int, float)) and divisor == 0:
                zero = [torch.tensor(True)]
            if zero:
                self.record(torch.stack([z.to(zero[0].device) for z in zero]).any(), "division by zero")
        out = func(*args, **kwargs)
        if name not in _CARRY:
            self.record(_any_nan(_tensors(out) or _written(func, args, kwargs)),
                        f"nan generated by primitive: {name}.")
        return out


def _checker() -> _Checker | None:
    """The innermost `checked` call's mode on this thread (autograd's worker
    threads inherit the mode stack), or None."""
    return next((m for m in reversed(_get_current_dispatch_mode_stack()) if isinstance(m, _Checker)), None)


@contextlib.contextmanager
def _unchecked(checker):
    """The guards' own flags are not checked (isfinite itself runs `abs`,
    which a NaN would flag)."""
    if checker is None:
        yield
        return
    checker.quiet = True
    try:
        yield
    finally:
        checker.quiet = False


def record_kernel(name: str, outputs) -> None:
    """Check a hand-written kernel's outputs as one primitive called `name`
    (kernels/_build.check calls this after a launch while `active`).
    Nothing happens outside `checked`."""
    checker = _checker()
    if checker is not None:
        with _unchecked(checker):
            flag = _any_nan(_tensors(list(outputs)))
        checker.record(flag, f"nan generated by primitive: {name}.")


def _leaves(tree) -> list:
    """The leaves of a (nested) dict, list or tuple, dict keys sorted (the
    order of jax.tree_util and of utils/tree.py); None is no leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _finite_flags(leaves) -> list[torch.Tensor]:
    return [torch.isfinite(torch.as_tensor(leaf)).all() for leaf in leaves]


def _read(flags: list[torch.Tensor]) -> list[bool]:
    """The flags on the host: one read a device."""
    out: list[bool | None] = [None] * len(flags)
    by_dev: dict = {}
    for i, f in enumerate(flags):
        by_dev.setdefault(f.device, []).append(i)
    for idx in by_dev.values():
        for i, v in zip(idx, torch.stack([flags[i] for i in idx]).cpu().tolist()):
            out[i] = bool(v)
    return out


def assert_all_finite(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming the leaves of `tree` that hold a NaN
    or an inf. The leaves' flags are stacked on their device and read once."""
    leaves = _leaves(tree)
    if not leaves:
        return
    with _unchecked(_checker()):
        ok = _read(_finite_flags(leaves))
    if not all(ok):
        bad = [i for i, v in enumerate(ok) if not v]
        raise FloatingPointError(f"non-finite values in {name} (leaves {bad})")


def guard_fields(fields, name: str = "fields"):
    """Returns fields unchanged. Under `checked`, records for each leaf i
    whether it is finite ("non-finite values in {name}[i]"); outside it,
    raises CheckError with that message for the first non-finite leaf."""
    leaves = _leaves(fields)
    messages = [f"non-finite values in {name}[{i}]" for i in range(len(leaves))]
    checker = _checker()
    with _unchecked(checker):
        flags = [~f for f in _finite_flags(leaves)]
    if checker is not None:
        for f, m in zip(flags, messages):
            checker.record(f, m)
    elif flags:
        Error(flags, messages).throw()
    return fields


def checked(fn):
    """fn wrapped so that a call returns (err, out): err.get() is the first
    error's message or None, err.throw() raises it (see the module
    docstring for what is checked)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global active
        active += 1
        try:
            with _Checker() as checker:
                out = fn(*args, **kwargs)
        finally:
            active -= 1
        return Error(checker.flags, checker.messages), out

    return wrapper
