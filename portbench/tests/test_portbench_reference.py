"""The reference agrees with the port's plain versions at a small grid on the
CPU (only this test imports both), and its Adam with torch.optim.Adam."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.core import inputs, program
from portbench.reference import ngp as ref_ngp
from portbench.reference import train as ref
from portbench.reference.grid import Grid
from portbench.reference.precision import REFERENCE
from portbench.tests.conftest import small_cell

CPU = torch.device("cpu")


def _leaf_close(ref_pairs, prog: dict, rel: float):
    ref_d = dict(ref_pairs)
    scale = max(float(v.norm()) for v in ref_d.values())
    for path, v in ref.flatten(prog):
        r = ref_d[path]
        assert float((v.double() - r).norm()) <= rel * (scale + float(r.norm())), path


def _setup(name, seed=4):
    cell = small_cell(name)
    c = cell.config
    return cell, c, Grid(**c["grid"]), inputs.make_params(c, seed, CPU)


@pytest.mark.parametrize("t", [0.125, 0.8])
def test_mlp_physics_loss_and_gradient(t):
    from phys_autodiff_tpu_torch.train.loop import loss_fn

    cell, c, g, p = _setup("mlp_train_256")
    loss_r, grads_r = ref.physics_loss_and_grad(c, ref.cast(p, REFERENCE, grad=True), g, c["weights"], t, REFERENCE)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss = loss_fn(program.grid_spec(c), program.phys_weights(c), program.model_config(c), leaves, t)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    _leaf_close(grads_r, grads, 1e-4)


def test_ngp_encoding():
    from phys_autodiff_tpu_torch.models import encoders

    cell, c, g, p = _setup("ngp_train_256")
    enc_p = encoders.encode_grid(program.model_config(c).encoding, p["tables"], program.grid_spec(c))
    enc_r = ref_ngp.encode(c["encoding"], ref.cast(p, REFERENCE)["tables"], g, torch.arange(g.nz))
    assert enc_p.shape == enc_r.shape
    assert float((enc_p.double() - enc_r).abs().max()) <= 1e-6 * float(enc_r.abs().max())


def test_ngp_physics_loss_and_gradient():
    from phys_autodiff_tpu_torch.kernels.mega_ngp import ngp_loss_and_grad_plain

    cell, c, g, p = _setup("ngp_train_256")
    t = 0.375
    loss_r, grads_r = ref.physics_loss_and_grad(c, ref.cast(p, REFERENCE, grad=True), g, c["weights"], t, REFERENCE)
    loss, (grads, _) = ngp_loss_and_grad_plain(program.grid_spec(c), program.phys_weights(c), program.model_config(c),
                                               p, t)
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    _leaf_close(grads_r, grads, 1e-4)


def test_ngp_data_loss_and_gradient():
    from phys_autodiff_tpu_torch.train.fit_field import FitTarget, make_fit_loss

    cell, c, g, p = _setup("ngp_fit_256")
    target = dict(inputs.trig_mix(c["grid"], CPU), t=0.25)
    loss_r, grads_r = ref.data_loss_and_grad(c, ref.cast(p, REFERENCE, grad=True), g, c["weights"], target, REFERENCE)
    leaves = [v.clone().requires_grad_() for _, v in ref.flatten(p)]
    tree = ref.unflatten(list(zip([k for k, _ in ref.flatten(p)], leaves)), p)
    loss = make_fit_loss(program.grid_spec(c), program.model_config(c),
                         [FitTarget(target["sigma"], target["u"], 0.25)], program.phys_weights(c))(tree)
    grads = ref.unflatten(list(zip([k for k, _ in ref.flatten(p)], torch.autograd.grad(loss, leaves))), p)
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-6)
    _leaf_close(grads_r, grads, 1e-5)


@pytest.mark.parametrize("name", ["mlp_serve_256", "ngp_train_256"])
def test_served_field(name):
    from phys_autodiff_tpu_torch.models.sample import grid_infer_any

    cell, c, g, p = _setup(name)
    with torch.no_grad():
        y = grid_infer_any(program.grid_spec(c), program.model_config(c), p, 0.6)
    truth = torch.cat([f for _, _, f in ref.field_blocks(c, ref.cast(p, REFERENCE), g, 0.6, REFERENCE)])
    assert float((y.double() - truth).abs().max()) <= 1e-6 * float(truth.abs().max())


def test_adam_is_torch_adam():
    gen = torch.Generator().manual_seed(0)
    p0 = {"a": torch.randn(5, generator=gen, dtype=torch.float64), "b": {"c": torch.randn(3, 2, generator=gen,
                                                                                       dtype=torch.float64)}}
    centres = [torch.randn(5, generator=gen, dtype=torch.float64), torch.randn(3, 2, generator=gen, dtype=torch.float64)]

    def loss_and_grad(params, k):
        pairs = ref.flatten(params)
        loss = sum(((v - c) ** 2).sum() * (k + 1) for (_, v), c in zip(pairs, centres))
        return loss, [(path, 2 * (v.detach() - c) * (k + 1)) for (path, v), c in zip(pairs, centres)]

    out = ref.trajectory({}, p0, None, {}, 0.01, 3, REFERENCE, loss_and_grad)
    leaves = [v.clone().requires_grad_() for _, v in ref.flatten(p0)]
    opt = torch.optim.Adam(leaves, lr=0.01, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for k in range(3):
        for v, c in zip(leaves, centres):
            v.grad = 2 * (v.detach() - c) * (k + 1)
        opt.step()
    for (path, ch), v, (_, v0) in zip(out["change"], leaves, ref.flatten(p0)):
        np.testing.assert_allclose(ch.numpy(), (v.detach() - v0).numpy(), rtol=1e-12, atol=1e-15)
