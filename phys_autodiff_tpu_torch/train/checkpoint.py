"""Checkpoint save / restore in the JAX package's npz format (port of
phys_autodiff_tpu/train/checkpoint.py:28-171; its orbax arm is not ported).

A checkpoint is ONE .npz holding the leaves `leaf_0..` and the manifest
`__manifest__` (JSON: the tree structure string, the leaf count, and the
optional `meta` / `extra` dicts), replaced atomically, plus a
human-readable `<path>.tree.json` sidecar with the same manifest.

Leaves are flattened as jax.tree_util flattens them: dict keys sorted,
lists and tuples in order. So a params dict {W1, b1, W2, b2}, or the
encoded-field model's nested {"tables": ..., W1, b1, W2, b2} (with
meta=ngp.checkpoint_meta(cfg)), crosses between the packages both ways: its
structure string is the JAX treedef string, so the JAX restore_npz accepts
a file written here, and restore_npz here accepts one written there.

A TrainState (train/loop.py) round-trips within the port only: its
optimizer state is torch.optim's, not optax's. It is saved as the tree
{"opt": the optimizer's per-parameter state, "params": ..., "rng": the
generator state, "step": ...}; the hyperparameters of the optimizer come
from the `like` state it is restored into.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any

import numpy as np
import torch

from phys_autodiff_tpu_torch.utils import tree as tree_util


def _is_state(tree) -> bool:
    from phys_autodiff_tpu_torch.train.loop import TrainState

    return isinstance(tree, TrainState)


def _opt_tree(opt: torch.optim.Optimizer) -> dict:
    """The per-parameter optimizer state by parameter index. Adam and AdamW
    create theirs at the first step; before it, their zero state stands in
    (it steps exactly as the fresh optimizer does), so a fresh state can be
    the `like` of a restore."""
    state = opt.state_dict()["state"]
    params = [p for group in opt.param_groups for p in group["params"]]
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        def zero(p):
            return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p),
                    "step": torch.tensor(0.0)}

        return {str(i): dict(state.get(i) or zero(p)) for i, p in enumerate(params)}
    return {str(i): dict(state[i]) for i in sorted(state)}


def _state_tree(state) -> dict:
    return {
        "opt": _opt_tree(state.opt),
        "params": state.params,
        "rng": state.gen.get_state(),
        "step": torch.tensor(state.step, dtype=torch.int64),
    }


def _flatten(tree: Any):
    """(leaves, structure string) in jax.tree_util's order and notation."""
    if _is_state(tree):
        tree = _state_tree(tree)
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(v) for v in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_npz(path: str, tree: Any, meta: dict | None = None, extra: dict | None = None) -> None:
    """Save a params dict, a TrainState, or a dict / list / tuple tree of
    tensors to <path>.npz (+ the <path>.tree.json sidecar). `meta` is
    checked by restore_npz(expect_meta=...); `extra` is free bookkeeping,
    read back with read_manifest()."""
    leaves, treedef = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    npz_path = _npz_path(path)
    manifest = {"treedef": treedef, "n_leaves": len(leaves)}
    if meta is not None:
        manifest["meta"] = meta
    if extra is not None:
        manifest["extra"] = extra
    manifest_json = json.dumps(manifest)
    tmp = npz_path + ".tmp.npz"
    np.savez(
        tmp,
        __manifest__=np.frombuffer(manifest_json.encode(), dtype=np.uint8),
        **{f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)},
    )
    os.replace(tmp, npz_path)
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    with open(sidecar + ".tmp", "w") as f:
        f.write(manifest_json)
    os.replace(sidecar + ".tmp", sidecar)


def read_manifest(path: str) -> dict | None:
    """The checkpoint's manifest (embedded, else the sidecar), or None."""
    npz_path = _npz_path(path)
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    with np.load(npz_path) as data:
        if "__manifest__" in data.files:
            return json.loads(bytes(data["__manifest__"].tobytes()).decode())
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return None


def _unflatten(like: Any, leaves: list):
    """`like`'s structure filled with `leaves` (tensors on like's devices)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            return vals if isinstance(node, list) else type(node)(vals)
        if node is None:
            return None
        arr = next(it)
        if isinstance(node, torch.Tensor):
            return torch.as_tensor(arr, dtype=node.dtype).to(node.device)
        return arr

    return build(like)


def _restore_state(like, tree: dict):
    from phys_autodiff_tpu_torch.train.loop import TrainState

    params = tree_util.map_tree(lambda v: v.requires_grad_(), tree["params"])
    opt = type(like.opt)(tree_util.leaves(params), **like.opt.defaults)
    sd = like.opt.state_dict()
    sd["state"] = {int(i): v for i, v in tree["opt"].items()}
    opt.load_state_dict(sd)
    gen = torch.Generator(device=like.gen.device)
    gen.set_state(tree["rng"])
    return TrainState(params=params, opt=opt, step=int(tree["step"]), gen=gen)


def restore_npz(
    path: str, like: Any, expect_meta: dict | None = None, allow_unvalidated: bool = False
) -> Any:
    """Restore into the structure of `like`, validating the manifest's leaf
    count and structure string against it (a file without a manifest is
    refused unless allow_unvalidated=True, which checks the leaf count
    only, with a warning). `expect_meta`, when given, must equal the saved
    meta; a checkpoint without meta restores with a warning."""
    npz_path = _npz_path(path)
    sidecar = npz_path[: -len(".npz")] + ".tree.json"
    like_leaves, treedef = _flatten(like)
    with np.load(npz_path) as data:
        if "__manifest__" in data.files:
            manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
        elif os.path.exists(sidecar):
            with open(sidecar) as f:
                manifest = json.load(f)
        elif allow_unvalidated:
            n_data = len([k for k in data.files if k.startswith("leaf_")])
            if n_data != len(like_leaves):
                raise ValueError(
                    f"checkpoint has {n_data} leaves but `like` has {len(like_leaves)} — "
                    "structure mismatch"
                )
            warnings.warn(
                f"checkpoint {npz_path} has no manifest; restoring by leaf index only "
                "(tree structure unverified)",
                stacklevel=2,
            )
            manifest = None
        else:
            raise ValueError(
                f"checkpoint {npz_path} has no embedded manifest and no {sidecar} sidecar — "
                "cannot validate the tree structure (pass allow_unvalidated=True to restore by "
                "leaf index)"
            )
        if manifest is not None:
            if manifest.get("n_leaves") != len(like_leaves):
                raise ValueError(
                    f"checkpoint has {manifest.get('n_leaves')} leaves but `like` has "
                    f"{len(like_leaves)} — structure mismatch"
                )
            if manifest.get("treedef") != treedef:
                raise ValueError(
                    "checkpoint treedef does not match `like`:\n"
                    f"  saved: {manifest.get('treedef')}\n  like:  {treedef}"
                )
        if expect_meta is not None:
            saved = manifest.get("meta") if manifest is not None else None
            if saved is None:
                warnings.warn(
                    f"checkpoint {npz_path} carries no meta entry; expected {expect_meta} "
                    "cannot be verified",
                    stacklevel=2,
                )
            elif saved != expect_meta:
                raise ValueError(
                    f"checkpoint meta does not match:\n  saved:    {saved}\n  expected: {expect_meta}"
                )
        leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    if _is_state(like):
        return _restore_state(like, _unflatten(_state_tree(like), leaves))
    return _unflatten(like, leaves)
