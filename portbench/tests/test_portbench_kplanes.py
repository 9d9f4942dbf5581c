"""The kplanes family (families/kplanes.py, reference/kplanes.py) and its
cell kplanes_train_256: the weights' bits at seeds 0 and 1 (sha256 of each
leaf's float32 bytes on the CPU), the counts, discovery by name, and a run
of the cell on a small grid and configuration on the CPU, judged by the
reference."""

from __future__ import annotations

import copy
import hashlib
import io
import json
import time

import pytest
import torch

from portbench.core import harness, inputs, specs, work
from portbench.reference import kplanes as ref_kplanes
from portbench.reference.grid import Grid
from portbench.reference.precision import REFERENCE
from portbench.reference.train import flatten
from portbench.tests.conftest import ROOT, SMALL

CELL = "kplanes_train_256"

PARAMS = {
    "kplanes_hybrid/0": {
        "W1": "f3fedc7cac94706d7b728a6df52e3321136336f302620bd9a70ed315b0939b5d",
        "W2": "ae6ff2c2acb810349cc4dbd3667445c09f076ccd757da769b7649555cf686409",
        "b1": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
        "b2": "374708fff7719dd5979ec875d56cd2286f6d3cf7ec317a3b25632aab28ec37bb",
        "tables/s0/xt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s0/xy": "9a0c175aebc0ba9a41a0a8f2dc59476ea8ecb46f5249be260c4ab830400f8de8",
        "tables/s0/xz": "9aa058087ac021e35ed6a4b71c0042ede25b6434bee92edd29909976721d9ba7",
        "tables/s0/yt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s0/yz": "3f998a4e7651c1cc71e5bf74b49144e13e1c0d182b644f645bee7145c532f273",
        "tables/s0/zt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s1/xt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s1/xy": "747f2f3d0d9ee33c24ad62e2eed2a59c4c86b2c3856c0c87e658120ca143bab2",
        "tables/s1/xz": "6d89def0e51837a913188f4134eeebecef4231e468bf7fb4537dfdb69bb6d9b6",
        "tables/s1/yt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s1/yz": "90156a8c57b2be9f7d8973910bd46ebb86a047be0904ed178e1708cbe531edda",
        "tables/s1/zt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s2/xt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s2/xy": "b13a5495ab01738d825a085e48713abcaa3a44d16a42fd2618b7a36d9609f552",
        "tables/s2/xz": "945e6bc967621ca7f3fc818fae96b3c322d751b2092d3b513d8e276957f83d22",
        "tables/s2/yt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s2/yz": "164cda8ec762154e30f406c2a6dcd13cd0e9829c1ccfa78f068e97b1c41f204a",
        "tables/s2/zt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s3/xt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
        "tables/s3/xy": "9a2a1b5c06c31acfe9c7c54433ff78fa1c9ad1d539603c59be20cc99ea962ce8",
        "tables/s3/xz": "aca900f5dd70ae2097b6205ab72ced746620931d23061adec7be674e25597eb3",
        "tables/s3/yt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
        "tables/s3/yz": "af155709a605130de41f2597d98bca8c4918825c545f2ca09052b17956fd40a6",
        "tables/s3/zt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
    },
    "kplanes_hybrid/1": {
        "W1": "f96c014d44c5a5889d5918099b8778d196c3c3b436067c54a9aec3cdc20895bd",
        "W2": "d078feea289bf84a1ba9b9ba7e3c2f13d96f4b96a23dc3ccf6e76bfaae3f765b",
        "b1": "5341e6b2646979a70e57653007a1f310169421ec9bdd9f1a5648f75ade005af1",
        "b2": "374708fff7719dd5979ec875d56cd2286f6d3cf7ec317a3b25632aab28ec37bb",
        "tables/s0/xt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s0/xy": "64dce5c4112a5487cd4fdb5ae356e09a02081fb1bc30630b234e9110933032b0",
        "tables/s0/xz": "f174c29aa492133b76dede4fc47414946626b9f12d6db434252eefba76cfad1f",
        "tables/s0/yt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s0/yz": "84bab40e2e764c1e6e1627b2397a6dc894ab1c2552b5c75a0021d8a46ce696d1",
        "tables/s0/zt": "e8a9cf64882d98781344cc31b4bf3d8750f53c664ecd86fe5d4d2550dd24d163",
        "tables/s1/xt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s1/xy": "6e204ec39bbb06804566571bd901ea566c304f7690e1e9d8848540027e7935e5",
        "tables/s1/xz": "31e5d5be9c532d0fd6b6180fdd818e8c75a395e9e3e7fcac113e9290aa11af01",
        "tables/s1/yt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s1/yz": "f936b47e33160a0a643880fabe262e4f1fb315a84a63082d10067fc2eb193992",
        "tables/s1/zt": "49dc324a6e10e94e67ec255a8fcf974671fcf68a1fd47fc08356d831d94893af",
        "tables/s2/xt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s2/xy": "233d3f9455f3be365b11095f6f9e57b87d2dc5f1e1c0a9de17858c639b923d6f",
        "tables/s2/xz": "b19da0b07f49727016eff4b12c8179341f9d2fff0253b47f5f7c0a942d8703e4",
        "tables/s2/yt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s2/yz": "02fc632ab6e5558826df926d6d3aed991890ebc4921d88a9e70d24c88dfd3538",
        "tables/s2/zt": "440e69f57bd842d587ad77f2b1a460208cde2c8bcb12bec8cb10632b2773d4f9",
        "tables/s3/xt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
        "tables/s3/xy": "2b358863efe37d77d1c6fa6aa3b7369c5c9ea3f0b2eeaf77f9272770e03f0029",
        "tables/s3/xz": "ea3cdcf3f65411ea382a83d7b3f9802c586073ce166ddb66b26f8b2b1f058365",
        "tables/s3/yt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
        "tables/s3/yz": "3b6f89b28a1e3d7cc66d35004c991459364d5e2bff68b76e599fb45e49fe81b0",
        "tables/s3/zt": "ea5a8c35667ed1f4d60fd38a7bb17603c1703d24258f3a2804c1dfe60fa23e0d",
    },
}


def _config():
    return json.loads((ROOT / "portbench" / "configs" / "kplanes_hybrid.json").read_text())


@pytest.mark.parametrize("seed", [0, 1])
def test_make_params_gives_the_recorded_bits(seed):
    params = inputs.make_params(_config(), seed, torch.device("cpu"))
    got = {path: hashlib.sha256(leaf.detach().to(torch.float32).contiguous().numpy().tobytes()).hexdigest()
           for path, leaf in flatten(params)}
    assert got == PARAMS[f"kplanes_hybrid/{seed}"]


def test_init_is_the_published_one():
    config = _config()
    params = inputs.make_params(config, 3, torch.device("cpu"))
    for path, leaf in flatten(params["tables"]):
        if "t" in path.split("/")[-1]:
            assert bool((leaf == 1.0).all()), path
        else:
            assert 0.1 <= float(leaf.min()) and float(leaf.max()) <= 0.5, path
    assert params["W1"].shape == (128, 64) and params["W2"].shape == (64, 4)
    assert not params["b1"].any() and not params["b2"].any()


def test_the_counts():
    config = _config()
    assert work.params_count(config) == 35_735_876
    nbytes, ops = work.kernel_work("kplanes", config)
    assert (nbytes, ops) == (285_887_008, 2_594_093_137_920)
    assert abs(work.least_time_s(nbytes, ops) * 1e3 - 38.7178) < 1e-3
    assert [work.kernel_work(k, config) for k in ("K4", "K5", "K7", "grid_forward")] == [None] * 4
    assert work.unit_flops("train", config) == 2_594_521_968_432
    assert work.unit_flops("fit", config) is None and work.unit_flops("serve", config) is None


def test_the_cell_and_its_family_are_found_by_name():
    cell = specs.load_cell(ROOT, CELL)
    assert (cell.config_name, cell.traffic_name, cell.chips) == ("kplanes_hybrid", "train_uniform", 1)
    assert cell.config["family"] == "kplanes"
    fam = specs.family("kplanes")
    for name in ("model_config", "make_params", "train_step", "params_count", "kernel_work", "unit_flops"):
        assert callable(getattr(fam, name))
    assert {m["name"] for m in cell.end_to_end} == {"train_Mcells_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "torch_ops_ms.train", "optimizer_ms.train", "launches_per_step.train", "device_idle_pct.train",
        "step_mfu.train", "encode_ms.train", "encode_pullback_ms.train", "step_host_ms.train", "step_waits.train",
        "step_idle_ms.train", "kplanes_roofline"}
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change1_gap"}


class _Empty:
    units, window_s = 10, 1.0

    def per_unit_ms(self, select):
        return None


def test_the_roofline_reads_nothing_where_no_kernel_ran():
    cell = specs.load_cell(ROOT, CELL)
    ctx = harness.ReadContext(_Empty(), None, cell, frozenset())
    assert specs.metric_reader("kplanes_roofline")(ctx) is None


def _small_cell():
    cell = specs.load_cell(ROOT, CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["grid"].update(SMALL)
    cell.config["encoding"].update(base_resolution=4, multipliers=[1, 2], time_resolution=5, features=4)
    cell.config["hidden"] = 16
    return cell


def test_a_small_copy_of_the_cell_runs_and_is_judged_on_the_cpu():
    cell = _small_cell()
    out, err = io.StringIO(), io.StringIO()
    code = harness.run_cell(cell, 3141592653, 0.1, False, torch.device("cpu"), time.perf_counter(), out=out, err=err)
    assert code == 0, err.getvalue()[-3000:]
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"]["loss_gap"]["value"] < 1e-4 and res["checks"]["grad_gap"]["value"] < 1e-4
    assert res["checks"]["change1_gap"]["value"] < 1e-4


def test_the_reference_field_is_the_ports():
    """reference/kplanes.field (float64, grid_sample at the node pairs)
    against the port's grid_infer (float32, its own lerps): 1e-5 of the
    largest value."""
    from phys_autodiff_tpu_torch.models import ngp

    cell = _small_cell()
    config = cell.config
    params = inputs.make_params(config, 5, torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    for l in range(2):
        for name, leaf in params["tables"][f"s{l}"].items():
            params["tables"][f"s{l}"][name] = torch.rand(leaf.shape, generator=gen) + 0.5
    g = Grid(**config["grid"])
    rows = torch.arange(g.nz)
    want = ref_kplanes.field(config, _double(params), g, rows, 0.37, REFERENCE)
    model = specs.family("kplanes").model_config(config)
    from phys_autodiff_tpu_torch.utils.config import GridSpec

    got = ngp.grid_infer(GridSpec(**config["grid"]), model, params, 0.37)
    assert float((got.double() - want).abs().max() / want.abs().max()) < 1e-5


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()
